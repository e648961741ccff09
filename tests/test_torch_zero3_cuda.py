"""The scheduled ZeRO-3 store and the checkpoint round trip on a CUDA GPU.
Every test skips without a card.

At a small Llama width in bf16 (AdamW, chunked CE, gas 2, no remat), world
1 over NCCL in a spawned process: the store under the fp32 wire gives the
stage-2 wire's losses and fp32 masters bit for bit, each step after the
first (which traces the schedule) with no synchronising call
(``set_sync_debug_mode("error")``), K7 once a step; its int8 tiers stay
within the JAX tests' 0.05 of the fp32 store's losses; a checkpoint of the
store resumed by a fresh engine, and the same checkpoint loaded at stage 2,
take the uninterrupted run's next steps bit for bit. Under remat (the
engine's ``nothing_saveable`` around the model's per-layer
``dots_saveable``) the store again gives the stage-2 wire's losses and
masters bit for bit, its recomputes gathering each bucket again.

This file imports neither ``jax`` nor ``deepspeed_tpu``; on the card run
it with ``python -m pytest --noconftest -q tests/test_torch_zero3_cuda.py``."""

import json
import os
import tempfile

import pytest
import torch

pytestmark = pytest.mark.cuda

LR, ROWS, SEQ, GAS = 1e-3, 2, 64, 2


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the store trains on the card")
    return torch.device("cuda")


def _engine(stage, zero_extra=None, remat=False):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
    reset_mesh_context()
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_attention_heads=2,
                           num_key_value_heads=1, ce_chunk_size=128, remat=remat,
                           remat_policy="dots_saveable" if remat else None)
    model = init_llama_for_causal_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    zero = {"stage": stage, "stage3_param_persistence_threshold": 0}
    zero.update(zero_extra or {})
    config = {"train_batch_size": ROWS * GAS, "gradient_accumulation_steps": GAS,
              "bf16": {"enabled": True}, "zero_optimization": zero,
              "gradient_comm": {"enabled": True, "overlap_comm": True, "bucket_size_mb": 0.5},
              "optimizer": {"type": "AdamW", "params": {"lr": LR, "weight_decay": 0.01}}}
    if remat:
        config["activation_checkpointing"] = {"remat_policy": "nothing_saveable"}
    return deepspeed_tpu_torch.initialize(model=model, config=config)[0]


def _data():
    gen = torch.Generator(device="cuda").manual_seed(3)
    return torch.randint(0, 256, (4 * GAS, ROWS, SEQ), generator=gen, device="cuda")


def _steps(eng, data, lo, hi, check_sync=False):
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    fo.adam_step_.launches = 0
    fetch, losses = eng._fetch, []

    def outside(x):
        torch.cuda.set_sync_debug_mode(0)
        return fetch(x)

    eng._fetch = outside
    for k in range(lo, hi):
        if check_sync and k > 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            losses.append(eng.train_batch(iter([(data[k * GAS + i], data[k * GAS + i])
                                                for i in range(GAS)])))
        finally:
            torch.cuda.set_sync_debug_mode(0)
    del eng._fetch
    return losses, fo.adam_step_.launches


def _masters(eng):
    return {k: v.cpu() for k, v in eng.full_master_params().items()}


def _store(data, ok):
    s2 = _engine(2)
    base, _ = _steps(s2, data, 0, 3)
    base_m = _masters(s2)
    del s2
    s3 = _engine(3)
    losses, k7 = _steps(s3, data, 0, 3, check_sync=True)
    m = _masters(s3)
    ok["store_engaged"] = s3._store is not None
    ok["bit_equal"] = losses == base and all(torch.equal(m[k], v) for k, v in base_m.items())
    ok["k7"] = k7 == 3
    del s3
    q = _engine(3, {"zero_quantized_weights": True, "zero_quantized_gradients": True})
    ql, _ = _steps(q, data, 0, 3)
    ok["int8"] = all(abs(a - b) <= 0.05 * abs(b) for a, b in zip(ql, losses)) and ql != losses


def _remat(data, ok):
    s2 = _engine(2, remat=True)
    base, _ = _steps(s2, data, 0, 3)
    base_m = _masters(s2)
    del s2
    s3 = _engine(3, remat=True)
    losses, k7 = _steps(s3, data, 0, 3)
    m = _masters(s3)
    ok["store_engaged"] = s3._store is not None
    ok["regathered"] = s3._store.stats["recompute_gathers"] > 0
    ok["bit_equal"] = losses == base and all(torch.equal(m[k], v) for k, v in base_m.items())
    ok["k7"] = k7 == 3


def _checkpoint(data, ok, tmp):
    a = _engine(3)
    _steps(a, data, 0, 2)
    ok["saved"] = a.save_checkpoint(tmp, tag="t")
    ref, _ = _steps(a, data, 2, 4)
    ref_m = _masters(a)
    del a
    for stage in (3, 2):
        b = _engine(stage)
        b.load_checkpoint(tmp, tag="t")
        got, _ = _steps(b, data, 2, 4)
        ok[f"resume_stage{stage}"] = got == ref and all(
            torch.equal(v, ref_m[k]) for k, v in _masters(b).items())
        del b


def _world1(rank, part, store, out, tmp):
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    ok = {}
    if part == "store":
        _store(_data(), ok)
    elif part == "remat":
        _remat(_data(), ok)
    else:
        _checkpoint(_data(), ok, tmp)
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(ok, f)


def _spawn(part):
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "out.json")
    mp.start_processes(_world1, args=(part, os.path.join(tmp, "store"), out,
                                      os.path.join(tmp, "ckpt")), nprocs=1,
                       start_method="spawn")
    with open(out) as f:
        return json.load(f)


def test_world1_store_bit_equals_stage2_wire_on_the_card(cuda_device):
    assert _spawn("store") == {"store_engaged": True, "bit_equal": True, "k7": True,
                               "int8": True}


def test_world1_store_under_remat_bit_equals_stage2_wire_on_the_card(cuda_device):
    assert _spawn("remat") == {"store_engaged": True, "regathered": True, "bit_equal": True,
                               "k7": True}


def test_world1_checkpoint_round_trip_on_the_card(cuda_device):
    assert _spawn("checkpoint") == {"saved": True, "resume_stage3": True,
                                    "resume_stage2": True}
