"""deepspeed_tpu_torch attention dispatch against the JAX package's: the
same Decisions and notes from ``resolve`` for the same inputs, env and
measured table (the cases of ``tests/unit/ops/test_kernel_dispatch.py``),
the port's autotune cache, a measured entry changing which port kernel
runs, and the sweep committing what ``resolve`` then reads (on the CPU,
where the kernel legs run their plain versions, under device kind
``cpu``). ``tests/conftest.py`` points ``DS_TPU_ATTN_CACHE_DIR`` at an
empty directory per test; both packages read the table there."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import kernel_dispatch as jkd
from deepspeed_tpu.ops.autotune_cache import get_cache as jax_get_cache
from deepspeed_tpu_torch.ops import attention as fa
from deepspeed_tpu_torch.ops import attention_folded as ff
from deepspeed_tpu_torch.ops import attn_sweep
from deepspeed_tpu_torch.ops import kernel_dispatch as kd
from deepspeed_tpu_torch.ops.autotune_cache import (CACHE_VERSION, AutotuneCache,
                                                    cache_path, get_cache)

BENCH = dict(q_shape=(8, 1024, 16, 64), kv_heads=16, seq_k=1024, causal=True,
             window=None, softcap=None)
MISTRAL = dict(q_shape=(1, 8192, 32, 128), kv_heads=8, seq_k=8192, causal=True,
               window=4096, softcap=None)


def _sigs(dtype="bfloat16", **over):
    """The same signature in both packages (JAX takes a numpy dtype, the
    port a torch dtype)."""
    a = {**BENCH, **over}
    args = (a["q_shape"], a["kv_heads"], a["seq_k"])
    rest = (a["causal"], a["window"], a["softcap"])
    return (jkd.make_sig(*args, jnp.dtype(dtype), *rest),
            kd.make_sig(*args, getattr(torch, dtype), *rest))


def _commit_both_read(leg, sig, kind, entry):
    """Commit through the JAX writer: the port reads the same file."""
    jax_get_cache().commit(jkd.signature(leg, sig, kind), entry)


# name -> (signature overrides, kind, env, [(leg, kind, entry)], resolve kwargs)
SCENARIOS = {
    "bench_heuristic": ({}, "TPU v5e", {}, [], {}),
    "short_seq": (dict(q_shape=(8, 512, 16, 64), seq_k=512), "TPU v5e", {}, [], {}),
    "seq_1023": (dict(q_shape=(8, 1023, 16, 64), seq_k=1023), "TPU v5p", {}, [], {}),
    "big_heads": (dict(q_shape=(8, 1024, 8, 128)), "TPU v5e", {}, [], {}),
    "head_dim_96": (dict(q_shape=(2, 2048, 8, 96), kv_heads=2, seq_k=2048), "TPU v5p", {},
                    [], {}),
    "windowed": (dict(window=256), "TPU v5e", {}, [], {}),
    "softcapped": (dict(softcap=50.0), "TPU v5e", {}, [], {}),
    "mistral": (MISTRAL, "NVIDIA H100 80GB HBM3", {}, [], {}),
    # Gemma-2-9B's training calls at head_dim 256 (no BLOCK_TABLE entry:
    # both fall to DEFAULT_BLOCKS): the windowed and the global layers
    "gemma2_d256_window": (dict(q_shape=(1, 8192, 16, 256), kv_heads=8, seq_k=8192,
                                window=4096, softcap=50.0), "NVIDIA H100 80GB HBM3", {}, [], {}),
    "gemma2_d256_global": (dict(q_shape=(1, 8192, 16, 256), kv_heads=8, seq_k=8192,
                                softcap=50.0), "TPU v5e", {}, [], {}),
    "measured_fwd": ({}, "TPU v5e", {}, [("fwd", "TPU v5e", {
        "impl": "folded", "block_q": 512, "block_k": 1024, "ms": 33.3})], {}),
    "measured_other_kind": ({}, "TPU v4", {}, [("fwd", "TPU v5e", {
        "impl": "folded", "block_q": 512, "block_k": 1024})], {}),
    "measured_both": (MISTRAL, "TPU v5e", {}, [
        ("fwd", "TPU v5e", {"impl": "xla", "block_q": 128, "block_k": 128}),
        ("bwd", "TPU v5e", {"impl": "folded", "block_q": 64, "block_k": 64})], {}),
    "env_beats_measured": ({}, "TPU v5p", {"DS_TPU_ATTN_FWD": "pallas",
                                     "DS_TPU_ATTN_BWD": "xla"},
                           [("fwd", "TPU v5p", {"impl": "folded", "block_q": 256,
                                          "block_k": 256})], {}),
    "explicit_beats_env": ({}, "TPU v5p", {"DS_TPU_ATTN_FWD": "pallas",
                                     "DS_TPU_ATTN_BWD": "xla"},
                           [("fwd", "TPU v5p", {"impl": "folded", "block_q": 256,
                                          "block_k": 256})],
                           dict(impl_fwd="xla", impl_bwd="folded")),
    "env_bad_value": ({}, "TPU v5e", {"DS_TPU_ATTN_FWD": "cuda-graphs"}, [], {}),
    "legacy_folded_1": ({}, None, {"DS_TPU_FLASH_FOLDED": "1"}, [], {}),
    "legacy_folded_0": ({}, "TPU v5e", {"DS_TPU_FLASH_FOLDED": "0"}, [], {}),
    "pallas_only": ({}, "TPU v5e", {}, [], dict(pallas_only=True)),
    "pallas_only_legacy": ({}, "TPU v5e", {"DS_TPU_FLASH_FOLDED": "1"}, [],
                           dict(pallas_only=True)),
    "explicit_blocks": ({}, "TPU v6e", {}, [("bwd", "TPU v6e", {"impl": "pallas", "block_q": 512,
                                                    "block_k": 1024})],
                        dict(blocks=(128, 128))),
    "env_blocks": ({}, "TPU v6e", {"DS_TPU_FLASH_BLOCKS": "256,256"},
                   [("bwd", "TPU v6e", {"impl": "pallas", "block_q": 512, "block_k": 1024})],
                   {}),
    "bad_env_blocks": ({}, "TPU v6e", {"DS_TPU_FLASH_BLOCKS": "256x256"}, [], {}),
    "measured_blocks": ({}, "TPU v6e", {}, [("bwd", "TPU v6e", {"impl": "pallas", "block_q": 512,
                                                    "block_k": 1024})], {}),
    "measured_bad_impl": ({}, "TPU v5 lite", {}, [("fwd", "TPU v5 lite", {"impl": "cuda-graphs",
                                                      "block_q": 1, "block_k": 1})], {}),
    "measured_bad_blocks": ({}, "TPU v5 lite", {}, [("bwd", "TPU v5 lite", {"impl": "folded",
                                                        "block_q": "big"})], {}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_resolve_matches_jax(name, monkeypatch):
    over, kind, env, entries, kwargs = SCENARIOS[name]
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    jsig, tsig = _sigs(**over)
    for leg, entry_kind, entry in entries:
        _commit_both_read(leg, jsig, entry_kind, entry)
    # the legacy-env case forces both legs whatever the kind: no kind is
    # passed, and each package asks its own backend
    jdec = jkd.resolve(jsig, kind, **kwargs)
    tdec = kd.resolve(tsig, kind, **kwargs)
    assert [tuple(d) for d in tdec] == [tuple(d) for d in jdec]
    assert kd.describe(*tdec) == jkd.describe(*jdec)
    if kind is not None:
        for leg in ("fwd", "bwd"):
            assert kd.signature(leg, tsig, kind) == jkd.signature(leg, jsig, kind)


def test_heuristic_picks_kernels_on_the_training_paths():
    """The smoke's main paths: Llama-3-8B width (D 128, causal) and Mistral
    (window 4096) resolve both legs to the per-head kernels."""
    card = "NVIDIA H100 80GB HBM3"
    for over in (dict(q_shape=(2, 2048, 32, 128), kv_heads=8, seq_k=2048), MISTRAL):
        fwd, bwd = kd.resolve(_sigs(**over)[1], card)
        assert (fwd.impl, bwd.impl) == ("pallas", "pallas")
        assert fwd.source == bwd.source == "heuristic"


def test_resolved_note_matches_jax():
    assert kd.resolved_note(kind="TPU v5e") == jkd.resolved_note(kind="TPU v5e")
    assert kd.resolved_note(seq=8192, heads=32, kv_heads=8, head_dim=128,
                            kind="cpu") == jkd.resolved_note(
        seq=8192, heads=32, kv_heads=8, head_dim=128, kind="cpu")
    assert kd.resolved_note(kind="TPU v5e").startswith("attn[fwd=xla:heuristic,bwd=pallas@")


CARD = "NVIDIA H100 80GB HBM3"
# name -> (env, [(leg, entry)], resolve kwargs, (fwd impl, fwd source),
# (bwd impl, bwd source)) at the bench shape (D 64, S 1024, no window),
# where the JAX package's heuristic sends the forward to xla
CARD_CASES = {
    "heuristic": ({}, [], {}, ("pallas", "heuristic"), ("pallas", "heuristic")),
    "legacy_folded_0": ({"DS_TPU_FLASH_FOLDED": "0"}, [], {},
                        ("pallas", "heuristic"), ("pallas", "heuristic")),
    "measured_xla_ignored": ({}, [("fwd", {"impl": "xla", "block_q": 1, "block_k": 1}),
                                  ("bwd", {"impl": "xla", "block_q": 1, "block_k": 1})],
                             {}, ("pallas", "heuristic"), ("pallas", "heuristic")),
    "measured_folded": ({}, [("fwd", {"impl": "folded", "block_q": 128, "block_k": 128})],
                        {}, ("folded", "measured"), ("pallas", "heuristic")),
    "env_pin": ({"DS_TPU_ATTN_FWD": "xla"}, [], {}, ("xla", "env"), ("pallas", "heuristic")),
    "explicit_pin": ({}, [], dict(impl_fwd="xla", impl_bwd="xla"),
                     ("xla", "explicit"), ("xla", "explicit")),
}


@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_card_kind_resolves_to_kernels_unless_pinned(name, monkeypatch):
    """On a card's kind the heuristic and measured entries pick only the
    kernels (the TPU's xla pick at D 64, S >= 1024 is not carried over);
    only an explicit or env pin reaches the plain attention."""
    env, entries, kwargs, want_fwd, want_bwd = CARD_CASES[name]
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    sig = _sigs()[1]
    for leg, entry in entries:
        get_cache().commit(kd.signature(leg, sig, CARD), entry)
    fwd, bwd = kd.resolve(sig, CARD, **kwargs)
    assert ((fwd.impl, fwd.source), (bwd.impl, bwd.source)) == (want_fwd, want_bwd)
    assert kd.route_impls(CARD) == ("pallas", "folded")
    assert kd.route_impls("cpu") == kd.route_impls("TPU v5e") == ("xla", "pallas", "folded")
    assert kd.resolve(sig, "TPU v5e")[0].impl == "xla"  # the JAX package's pick


def test_device_kind_of_a_cpu_tensor():
    assert kd.device_kind(torch.device("cpu")) == "cpu"
    assert kd.dtype_name(torch.bfloat16) == "bfloat16" == kd.dtype_name("bfloat16")


# ---- the port's autotune cache ----

def test_cache_round_trip(tmp_path):
    c = AutotuneCache(str(tmp_path / "t.json"))
    assert c.lookup("k") is None
    c.commit("k", {"impl": "xla", "block_q": 128, "block_k": 128, "ms": 1.0})
    got = c.lookup("k")
    assert got["impl"] == "xla" and "utc" in got
    c.commit("k2", {"impl": "pallas", "block_q": 256, "block_k": 512})
    assert c.lookup("k")["impl"] == "xla"
    assert c.lookup("k2")["impl"] == "pallas"
    assert set(c.entries()) == {"k", "k2"}
    assert not (tmp_path / "t.json.tmp").exists()  # renamed into place


def test_cache_tolerates_torn_and_wrong_version(tmp_path):
    p = tmp_path / "t.json"
    p.write_text('{"version": 1, "entries": {"k": {"impl": "fol')  # torn
    c = AutotuneCache(str(p))
    assert c.lookup("k") is None
    assert "heuristic" in c.source_description()
    p.write_text(json.dumps({"version": CACHE_VERSION + 1,
                             "entries": {"k": {"impl": "xla"}}}))
    assert AutotuneCache(str(p)).lookup("k") is None
    c.commit("k", {"impl": "xla", "block_q": 128, "block_k": 128})
    doc = json.loads(p.read_text())
    assert doc["version"] == CACHE_VERSION and "k" in doc["entries"]
    assert c.source_description().startswith("measured")


def test_cache_bad_impl_entry_falls_back(monkeypatch, tmp_path):
    monkeypatch.setenv("DS_TPU_ATTN_CACHE_DIR", str(tmp_path))
    sig = _sigs()[1]
    get_cache().commit(kd.signature("fwd", sig, CARD),
                       {"impl": "cuda-graphs", "block_q": 1, "block_k": 1})
    fwd, _ = kd.resolve(sig, CARD)
    assert fwd.source == "heuristic"


def test_env_dir_precedence(monkeypatch, tmp_path):
    monkeypatch.setenv("DS_TPU_ATTN_CACHE_DIR", str(tmp_path / "a"))
    assert cache_path() == str(tmp_path / "a" / "attn_dispatch.json")
    monkeypatch.delenv("DS_TPU_ATTN_CACHE_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert cache_path() == str(tmp_path / "xdg" / "deepspeed_tpu_torch"
                               / "attn_dispatch.json")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert cache_path() == str(tmp_path / "home" / ".cache" / "deepspeed_tpu_torch"
                               / "attn_dispatch.json")


def test_table_source_reflects_cache_state(monkeypatch, tmp_path):
    monkeypatch.setenv("DS_TPU_ATTN_CACHE_DIR", str(tmp_path))
    assert "heuristic" in kd.table_source()
    get_cache().commit("sig", {"impl": "xla", "block_q": 1, "block_k": 1})
    assert kd.table_source().startswith("measured")


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    return calls


def _qkv(s=128, h=4, kv=2, d=32):
    rng = np.random.default_rng(7)
    return [torch.from_numpy(rng.normal(size=(2, s, n, d)).astype(np.float32))
            for n in (h, kv, kv)]


def test_cache_hit_changes_which_port_kernel_runs(monkeypatch):
    """A measured ``folded`` forward for the CPU kind moves the next call
    from K1's plain version to K3's, and the answer stays the same."""
    q, k, v = _qkv()
    k1 = _count_calls(monkeypatch, fa, "flash_attention_fwd_reference")
    k3 = _count_calls(monkeypatch, ff, "folded_attention_fwd_reference")
    before = fa.flash_attention(q, k, v, causal=True)
    assert (len(k1), len(k3)) == (1, 0)  # heuristic: pallas (K1)
    sig = kd.make_sig(q.shape, k.shape[2], k.shape[1], q.dtype, True, None, None)
    get_cache().commit(kd.signature("fwd", sig, "cpu"),
                       {"impl": "folded", "block_q": 128, "block_k": 128})
    assert kd.resolve(sig, "cpu")[0][::3] == ("folded", "measured")
    after = fa.flash_attention(q, k, v, causal=True)
    assert (len(k1), len(k3)) == (1, 1)
    # fp32, the same function by two plain versions: bit for bit
    torch.testing.assert_close(after, before, atol=0, rtol=0)


# ---- the sweep ----

def test_sweep_commits_what_resolve_reads(monkeypatch, tmp_path):
    monkeypatch.setenv("DS_TPU_ATTN_CACHE_DIR", str(tmp_path))
    results = attn_sweep.sweep_shape(1, 128, 4, 2, 32, "float32", True, window=48,
                                     iters=1, device="cpu")
    assert set(results) == {"fwd", "bwd"}
    for entry, rows in results.values():
        assert [r[0] for r in rows] == ["xla", "pallas", "folded"]  # one row each
        assert entry["impl"] in ("xla", "pallas", "folded")
        assert (entry["block_q"], entry["block_k"]) == kd.default_blocks(32)
    doc = json.loads((tmp_path / "attn_dispatch.json").read_text())
    assert doc["version"] == CACHE_VERSION and len(doc["entries"]) == 2
    sig = kd.make_sig((1, 128, 4, 32), 2, 128, torch.float32, True, 48, None)
    fwd, bwd = kd.resolve(sig, "cpu")
    assert fwd.source == bwd.source == "measured"
    assert (fwd.impl, bwd.impl) == (results["fwd"][0]["impl"], results["bwd"][0]["impl"])


def test_sweep_dry_run_commits_nothing(monkeypatch, tmp_path, capsys):
    monkeypatch.setenv("DS_TPU_ATTN_CACHE_DIR", str(tmp_path))
    assert attn_sweep.main(["--device", "cpu", "--batch", "1", "--seq", "64",
                            "--heads", "2", "--head-dim", "16", "--dtype", "float32",
                            "--iters", "1", "--impls", "pallas,folded",
                            "--dry-run"]) == 0
    out = capsys.readouterr().out
    assert "device_kind='cpu'" in out and "winner" in out
    assert not (tmp_path / "attn_dispatch.json").exists()


def test_sweep_takes_only_the_kinds_candidates(monkeypatch, tmp_path):
    """A card's sweep may not time the plain attention: resolve would not
    read an xla entry for its kind."""
    monkeypatch.setenv("DS_TPU_ATTN_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(kd, "device_kind", lambda device=None: CARD)
    with pytest.raises(ValueError, match="picks among"):
        attn_sweep.sweep_shape(1, 64, 2, 2, 16, "float32", True, iters=1,
                               impls=("xla", "pallas"), device="cpu")
    assert not (tmp_path / "attn_dispatch.json").exists()
