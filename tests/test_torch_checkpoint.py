"""deepspeed_tpu_torch's checkpointing (``checkpoint/``, the engine's
``save_checkpoint``/``load_checkpoint``) against the JAX package's.

The crash-consistency cases are JAX's ``tests/unit/checkpoint/
test_resilience.py`` on the port (its manifest, commit marker, torn and
corrupt tags, quarantine, retention and the async engine), driven by the
port's fault injector, with a float-input model that mirrors the JAX
``SimpleModel`` weight for weight. The JAX package's own ``verify_checkpoint``
reads the port's manifest. The stage-3 store round-trips and reshards
between stages 2 and 3 bit for bit: the resumed losses and masters are an
uninterrupted run's. The universal layout crosses the packages both ways:
a JAX checkpoint through JAX's ``ds_to_universal`` into the port's engine,
and a port checkpoint through the port's ``ds_to_universal`` into JAX's
``load_universal_checkpoint``; in each case the next two steps' losses agree
with the other package continuing (fp32, rtol 1e-5, as
test_torch_training.py holds the two engines' steps). ``zero_to_fp32``
gives JAX's keys, and values within the fp32 limits of
test_torch_grad_comm.py after the same two steps. The JAX engine runs in
this process on one host device.
"""

import json
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.checkpoint.engine import (
    COMMIT_MARKER_FILE, MANIFEST_FILE, AsyncCheckpointEngine, CheckpointCorruptionError,
    find_latest_valid_checkpoint, prune_checkpoints, read_latest_tag, scan_tags,
    verify_checkpoint, write_manifest)
from deepspeed_tpu_torch.models.convert import jax_key_path, lookup
from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
from deepspeed_tpu_torch.utils.fault_injection import get_fault_injector

SEQ, LR = 16, 1e-3
LOSS_RTOL, MASTER_TOL, MAX_FLIPPED = 1e-5, 1e-5, 4
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
            rope_theta=10000.0)


@pytest.fixture(autouse=True)
def _reset_port_faults():
    yield
    get_fault_injector().reset()


class SimpleModel(torch.nn.Module):
    """The JAX ``SimpleModel`` (``tests/unit/simple_model.py``): dense
    layers with ReLU between, returning the MSE; flax's kernel layout."""

    def __init__(self, hidden=16, nlayers=2):
        super().__init__()
        for i in range(nlayers + 1):
            layer = torch.nn.Module()
            layer.kernel = torch.nn.Parameter(torch.zeros(hidden, hidden))
            layer.bias = torch.nn.Parameter(torch.zeros(hidden))
            self.add_module(f"Dense_{i}", layer)
        self.n = nlayers + 1

    def forward(self, x, y):
        for i in range(self.n):
            layer = getattr(self, f"Dense_{i}")
            x = x @ layer.kernel + layer.bias
            if i < self.n - 1:
                x = torch.relu(x)
        return torch.mean((x - y) ** 2)


def simple_params(seed=0):
    """The JAX SimpleModel's initial params (numpy), from ``seed``."""
    import sys
    import jax
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "unit"))
    from simple_model import simple_model_and_params
    _, params = simple_model_and_params(seed=seed)
    return jax.tree_util.tree_map(np.asarray, params)


def simple_engine(config=None, seed=0):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    reset_mesh_context()
    model = SimpleModel()
    tree = simple_params(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.array(lookup(tree, name))))
    cfg = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    cfg.update(config or {})
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    return eng


def step(engine, x=None):
    x = torch.ones(8, 16) if x is None else x
    loss = engine.forward(x, torch.zeros_like(x))
    engine.backward(loss)
    engine.step()
    return loss


# ---------------------------------------------------------------- manifest and verification


def test_commit_writes_manifest_then_marker(tmp_path):
    from deepspeed_tpu.checkpoint.engine import verify_checkpoint as jax_verify
    e = simple_engine()
    step(e)
    assert e.save_checkpoint(tmp_path, tag="t") is True
    ckpt = tmp_path / "t"
    assert (ckpt / MANIFEST_FILE).exists() and (ckpt / COMMIT_MARKER_FILE).exists()
    manifest = json.loads((ckpt / MANIFEST_FILE).read_text())
    assert manifest["tag"] == "t"
    for rel, meta in manifest["entries"].items():
        assert os.path.getsize(ckpt / rel) == meta["size"]
    assert {"ds_host_state.pkl", "state_rank0.pt", "layout_rank0.json"} <= set(
        manifest["entries"])
    assert not [f for f in os.listdir(ckpt) if ".tmp" in f]  # every write renamed into place
    assert verify_checkpoint(str(ckpt)) == (True, "ok")
    assert jax_verify(str(ckpt)) == (True, "ok")  # the same manifest format


def test_verify_detects_size_and_checksum_mismatch(tmp_path):
    d = tmp_path / "c"
    d.mkdir()
    (d / "data.bin").write_bytes(b"x" * 100)
    write_manifest(str(d), "c")
    assert verify_checkpoint(str(d))[0]
    (d / "data.bin").write_bytes(b"y" * 100)
    ok, reason = verify_checkpoint(str(d))
    assert not ok and "checksum" in reason
    (d / "data.bin").write_bytes(b"x" * 50)
    ok, reason = verify_checkpoint(str(d))
    assert not ok and "size" in reason


def test_verify_legacy_and_torn_semantics(tmp_path):
    d = tmp_path / "legacy"
    d.mkdir()
    (d / "data.bin").write_bytes(b"z" * 10)
    assert verify_checkpoint(str(d), require_manifest=False)[0]
    assert not verify_checkpoint(str(d), require_manifest=True)[0]
    write_manifest(str(d), "legacy")
    os.remove(d / COMMIT_MARKER_FILE)
    for req in (True, False):
        ok, reason = verify_checkpoint(str(d), require_manifest=req)
        assert not ok and "torn" in reason


def test_scan_orders_numeric_steps_not_lexicographic(tmp_path):
    from deepspeed_tpu.checkpoint.engine import scan_tags as jax_scan
    for tag in ("global_step9", "global_step10", "global_step2"):
        d = tmp_path / tag
        d.mkdir()
        (d / "x").write_bytes(b"a")
        write_manifest(str(d), tag)
    assert scan_tags(str(tmp_path))[:2] == ["global_step10", "global_step9"]
    assert scan_tags(str(tmp_path)) == jax_scan(str(tmp_path))
    assert find_latest_valid_checkpoint(str(tmp_path)) == "global_step10"


# ---------------------------------------------------------------- torn or corrupt newest


def test_torn_write_fails_commit_and_latest_stays(tmp_path):
    e = simple_engine()
    step(e)
    assert e.save_checkpoint(tmp_path) is True
    assert read_latest_tag(str(tmp_path)) == "global_step1"
    step(e)
    get_fault_injector().configure({"faults": [{"site": "checkpoint.torn_write", "nth": 1}]})
    assert e.save_checkpoint(tmp_path) is False
    assert read_latest_tag(str(tmp_path)) == "global_step1"
    torn = tmp_path / "global_step2"
    assert torn.exists() and not (torn / COMMIT_MARKER_FILE).exists()
    e2 = simple_engine()
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("global_step1") and e2.global_steps == 1
    os.remove(tmp_path / "latest")
    e3 = simple_engine()
    path, _ = e3.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("global_step1") and e3.global_steps == 1


def test_corrupt_newest_falls_back_through_manifest(tmp_path):
    e = simple_engine()
    step(e)
    assert e.save_checkpoint(tmp_path) is True
    step(e)
    get_fault_injector().configure({"faults": [{"site": "checkpoint.corrupt", "nth": 1}]})
    assert e.save_checkpoint(tmp_path) is True
    assert read_latest_tag(str(tmp_path)) == "global_step2"
    ok, reason = verify_checkpoint(str(tmp_path / "global_step2"))
    assert not ok and "checksum" in reason
    e2 = simple_engine()
    path, _ = e2.load_checkpoint(str(tmp_path))
    assert path is not None and path.endswith("global_step1") and e2.global_steps == 1
    assert not (tmp_path / "global_step2").exists()
    assert (tmp_path / "global_step2.quarantined").exists()
    e3 = simple_engine()
    with pytest.raises(CheckpointCorruptionError):
        e3.load_checkpoint(str(tmp_path), tag="global_step2.quarantined")


def test_resume_from_fallback_restores_the_state(tmp_path):
    """The tag the fallback picks restores masters, moments and counters:
    the next step is the step the saving engine took from there."""
    e = simple_engine()
    x = torch.linspace(0.0, 1.0, 128).reshape(8, 16)
    step(e, x)
    assert e.save_checkpoint(tmp_path) is True
    ref = step(e, x).item()
    e2 = simple_engine(seed=1)
    e2.load_checkpoint(str(tmp_path))
    assert step(e2, x).item() == ref
    assert all(torch.equal(a, b) for a, b in zip(e.optimizer.state.values(),
                                                 e2.optimizer.state.values()))


# ---------------------------------------------------------------- retention


def test_prune_keeps_last_n_and_latest(tmp_path):
    e = simple_engine({"resilience": {"enabled": True, "keep_last_n": 2}})
    for _ in range(4):
        step(e)
        assert e.save_checkpoint(tmp_path) is True
    assert scan_tags(str(tmp_path)) == ["global_step4", "global_step3"]
    assert read_latest_tag(str(tmp_path)) == "global_step4"
    e.destroy()


def test_prune_ignores_uncommitted_dirs(tmp_path):
    for i in (1, 2, 3):
        d = tmp_path / f"global_step{i}"
        d.mkdir()
        (d / "x").write_bytes(b"a")
        write_manifest(str(d), f"global_step{i}")
    staging = tmp_path / "global_step4"
    staging.mkdir()
    (staging / "x").write_bytes(b"a")
    assert prune_checkpoints(str(tmp_path), keep_last_n=2) == ["global_step1"]
    assert staging.exists()
    assert prune_checkpoints(str(tmp_path), keep_last_n=0) == []


# ---------------------------------------------------------------- the async engine


def test_async_engine_seals_only_at_commit(tmp_path):
    eng = AsyncCheckpointEngine()
    path = str(tmp_path / "ck")
    state = {"w": torch.arange(8, dtype=torch.float32)}
    eng.save(state, path, host_state={"global_steps": 7})
    state["w"].zero_()  # the snapshot was taken at save
    assert not os.path.exists(os.path.join(path, COMMIT_MARKER_FILE))
    assert not verify_checkpoint(path, require_manifest=True)[0]
    assert eng.commit("ck") is True
    assert os.path.exists(os.path.join(path, MANIFEST_FILE))
    assert verify_checkpoint(path) == (True, "ok")
    restored, host = eng.load(path)
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(8, dtype=np.float32))
    assert host["global_steps"] == 7


def test_async_engine_torn_commit_reports_failure(tmp_path):
    get_fault_injector().configure({"faults": [{"site": "checkpoint.torn_write", "nth": 1}]})
    eng = AsyncCheckpointEngine()
    path = str(tmp_path / "ck")
    eng.save({"w": torch.ones(64)}, path, host_state={})
    assert eng.commit("ck") is False
    assert not os.path.exists(os.path.join(path, COMMIT_MARKER_FILE))
    assert find_latest_valid_checkpoint(str(tmp_path)) is None
    assert not verify_checkpoint(path, require_manifest=True)[0]


def test_post_commit_corruption_fails_load(tmp_path):
    get_fault_injector().configure({"faults": [{"site": "checkpoint.corrupt", "nth": 1}]})
    eng = AsyncCheckpointEngine()
    path = str(tmp_path / "ck")
    eng.save({"w": torch.ones(64)}, path, host_state={})
    assert eng.commit("ck") is True
    with pytest.raises(CheckpointCorruptionError):
        eng.load(path)


# ---------------------------------------------------------------- the store and its reshards


def _llama_engine(stage, seed=1, extra=None, gas=2):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    reset_mesh_context()
    model = init_llama_for_causal_lm(LlamaConfig(**TINY, dtype=torch.float32), seed=seed,
                                     device="cpu")
    cfg = {"train_batch_size": 2 * gas, "gradient_accumulation_steps": gas,
           "zero_optimization": {"stage": stage, "stage3_param_persistence_threshold": 64},
           "gradient_comm": {"enabled": True, "overlap_comm": True, "bucket_size_mb": 0.05},
           "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 3,
                                                        "warmup_max_lr": LR}},
           "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}}}
    cfg.update(extra or {})
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg, device="cpu")
    return eng


IDS = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (8, 2, SEQ)))


def _train(eng, s0, s1):
    return [eng.train_batch(iter([(IDS[2 * k + i], IDS[2 * k + i]) for i in range(2)]))
            for k in range(s0, s1)]


@pytest.mark.parametrize("save_stage,load_stage", [(3, 3), (2, 3), (3, 2), (1, 3)])
def test_store_round_trip_and_reshard(tmp_path, save_stage, load_stage):
    """Save after two steps, load into a fresh engine (another seed) at
    the same or the other stage, and take two more steps: the losses, the
    masters and the schedule's position are the uninterrupted run's, bit
    for bit."""
    a = _llama_engine(save_stage)
    _train(a, 0, 2)
    assert a.save_checkpoint(str(tmp_path), tag="t")
    ref = _train(a, 2, 4)
    b = _llama_engine(load_stage, seed=7)
    path, _ = b.load_checkpoint(str(tmp_path))
    assert path.endswith("t") and b.global_steps == 2
    assert (b._store is not None) == (load_stage == 3)
    assert b.last_load["saved_stage"] == save_stage
    assert _train(b, 2, 4) == ref
    ma, mb = a.full_master_params(), b.full_master_params()
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert b.get_lr() == a.get_lr() and b.optimizer.count == a.optimizer.count == 4


@pytest.mark.parametrize("stage", [2, 3])
def test_save_between_micro_steps_keeps_the_accumulation(tmp_path, stage):
    """A save after the first of two micro-steps holds the accumulation
    buffer (at a boundary it is zero and not written): the resumed engine's
    second micro-step and step give the uninterrupted run's masters."""
    from deepspeed_tpu_torch.checkpoint import ShardedReader
    a = _llama_engine(stage)
    _train(a, 0, 1)
    loss = a.forward(IDS[2], labels=IDS[2])
    a.backward(loss)
    assert a.save_checkpoint(str(tmp_path), tag="mid")
    assert ShardedReader(str(tmp_path / "mid")).has("grad_acc")
    a.backward(a.forward(IDS[3], labels=IDS[3]))
    a.step()
    b = _llama_engine(stage, seed=7)
    b.load_checkpoint(str(tmp_path), tag="mid")
    assert b.micro_steps == a.micro_steps - 1
    b.backward(b.forward(IDS[3], labels=IDS[3]))
    b.step()
    ma, mb = a.full_master_params(), b.full_master_params()
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    a2 = _llama_engine(stage)
    _train(a2, 0, 1)
    a2.save_checkpoint(str(tmp_path), tag="boundary")
    assert not ShardedReader(str(tmp_path / "boundary")).has("grad_acc")


def test_large_buffers_in_files_of_their_own(tmp_path, monkeypatch):
    """Each buffer of ``SPLIT_BYTES`` or more goes to a file of its own
    (written, summed and read side by side); the manifest covers them and
    the load reads them back."""
    from deepspeed_tpu_torch.checkpoint import engine as ce
    monkeypatch.setattr(ce, "SPLIT_BYTES", 1024)
    a = _llama_engine(3)
    _train(a, 0, 1)
    assert a.save_checkpoint(str(tmp_path), tag="t")
    ref = _train(a, 1, 2)
    parts = sorted(f for f in os.listdir(tmp_path / "t") if f.startswith("state_rank0."))
    assert len(parts) == 1 + len(a.optimizer.state) + 1  # masters, moments, the main file
    manifest = json.loads((tmp_path / "t" / MANIFEST_FILE).read_text())
    assert set(parts) <= set(manifest["entries"])
    b = _llama_engine(3, seed=7)
    b.load_checkpoint(str(tmp_path), tag="t")
    assert _train(b, 1, 2) == ref


def test_host_state_records_store_meta(tmp_path):
    e = _llama_engine(3)
    _train(e, 0, 1)
    e.save_checkpoint(str(tmp_path), tag="meta")
    saved = e._peek_zero3_store_meta(str(tmp_path / "meta"))
    assert saved["n_leaves"] == e._zero3_store.n_leaves
    assert saved["persistent_idx"] == list(e._zero3_store.p_idx)
    assert saved["pad_multiple"] == e._zero3_store.pad_multiple


def test_load_without_optimizer_states(tmp_path):
    a = _llama_engine(3)
    _train(a, 0, 2)
    a.save_checkpoint(str(tmp_path), tag="t")
    b = _llama_engine(3, seed=7)
    b.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    ma, mb = a.full_master_params(), b.full_master_params()
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert b.optimizer.count == 0 and all(float(v.abs().sum()) == 0
                                          for v in b.optimizer.state.values())


# ---------------------------------------------------------------- across the packages


def _jax_engine(tree):
    import jax
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.comm.mesh import MeshContext, reset_mesh_context, set_mesh_context
    from deepspeed_tpu.models.llama import LlamaConfig as JaxConfig, LlamaForCausalLM as JaxLM
    reset_mesh_context()
    set_mesh_context(MeshContext.create(axis_sizes={"data": 1}, devices=jax.devices()[:1]))
    eng, *_ = deepspeed_tpu.initialize(
        model=JaxLM(JaxConfig(**TINY, dtype=jnp.float32, attn_impl="xla")),
        model_parameters=jax.tree_util.tree_map(jnp.asarray, tree),
        config={"train_batch_size": 2,
                "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}}})
    return eng


def _port_engine(tree):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    from deepspeed_tpu_torch.models.convert import params_from_jax
    reset_mesh_context()
    model = params_from_jax(tree, LlamaConfig(**TINY, dtype=torch.float32),
                            dtype=torch.float32, device="cpu", training=True)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_batch_size": 2,
                "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}}})
    return eng


def _tree(seed):
    eng = init_llama_for_causal_lm(LlamaConfig(**TINY, dtype=torch.float32), seed=seed,
                                   device="cpu")
    tree = {}
    for name, p in eng.named_parameters():
        node = tree
        path = jax_key_path(name)
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach().numpy().copy()
    return tree


def _jax_steps(eng, s0, s1):
    import jax.numpy as jnp
    return [float(eng.train_batch(iter([(jnp.asarray(IDS[k].numpy()),
                                         jnp.asarray(IDS[k].numpy()))])))
            for k in range(s0, s1)]


def _port_steps(eng, s0, s1):
    return [eng.train_batch(iter([(IDS[k], IDS[k])])) for k in range(s0, s1)]


def test_universal_from_jax_into_port(tmp_path):
    """A JAX checkpoint through JAX's ds_to_universal resumes in the port's
    engine: its next two steps agree with the JAX engine's."""
    from deepspeed_tpu.checkpoint.universal import ds_to_universal as jax_to_universal
    j = _jax_engine(_tree(1))
    _jax_steps(j, 0, 2)
    j.save_checkpoint(str(tmp_path / "jax"), tag="t")
    jax_to_universal(str(tmp_path / "jax" / "t"), str(tmp_path / "uni"))
    ref = _jax_steps(j, 2, 4)
    p = _port_engine(_tree(5))
    p.load_universal_checkpoint(str(tmp_path / "uni"))
    assert p.global_steps == 2 and p.optimizer.count == 2
    np.testing.assert_allclose(_port_steps(p, 2, 4), ref, rtol=LOSS_RTOL)


def test_universal_from_port_into_jax(tmp_path):
    """A port checkpoint through the port's ds_to_universal resumes in the
    JAX engine's load_universal_checkpoint: its next two steps agree with
    the port's engine continuing; the layout is the JAX one, file for
    file."""
    from deepspeed_tpu.checkpoint.universal import load_universal as jax_load_universal
    from deepspeed_tpu_torch.checkpoint import ds_to_universal
    p = _port_engine(_tree(1))
    _port_steps(p, 0, 2)
    assert p.save_checkpoint(str(tmp_path / "port"), tag="t")
    ds_to_universal(str(tmp_path / "port" / "t"), str(tmp_path / "uni"))
    ref = _port_steps(p, 2, 4)
    meta = json.loads((tmp_path / "uni" / "universal_meta.json").read_text())
    assert meta["step"] == 2 and meta["has_optim_states"]
    assert set(jax_load_universal(str(tmp_path / "uni"))) == set(meta["params"])
    j = _jax_engine(_tree(5))
    j.load_universal_checkpoint(str(tmp_path / "uni"))
    np.testing.assert_allclose(_jax_steps(j, 2, 4), ref, rtol=LOSS_RTOL)


def test_zero_to_fp32_matches_jax_full_params(tmp_path):
    """The same two steps in both engines, each checkpointed: the port's
    zero_to_fp32 gives JAX's keys and JAX's values within fp32 limits."""
    from deepspeed_tpu.checkpoint.zero_to_fp32 import (
        get_fp32_state_dict_from_zero_checkpoint as jax_fp32)
    from deepspeed_tpu_torch.checkpoint import (convert_zero_checkpoint_to_fp32_state_dict,
                                                get_fp32_state_dict_from_zero_checkpoint)
    j, p = _jax_engine(_tree(1)), _port_engine(_tree(1))
    _jax_steps(j, 0, 2)
    _port_steps(p, 0, 2)
    j.save_checkpoint(str(tmp_path / "jax"))
    p.save_checkpoint(str(tmp_path / "port"))
    ref = jax_fp32(str(tmp_path / "jax"))
    got = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "port"))
    assert set(got) == set(ref)
    n_off = 0
    for k, v in got.items():
        diff = np.abs(v - ref[k])
        n_off += int((diff > MASTER_TOL + MASTER_TOL * np.abs(ref[k])).sum())
        assert diff.max() <= 2 * 2 * LR, k
    assert n_off <= MAX_FLIPPED
    out = convert_zero_checkpoint_to_fp32_state_dict(str(tmp_path / "port"),
                                                     str(tmp_path / "fp32.npz"))
    assert set(np.load(out).files) == set(ref)
