"""ZeRO stages 1-3 on a CUDA GPU. Every test skips without a card.

At a small Llama width in bf16 (AdamW, chunked CE, dots_saveable remat, 3
steps and a 2-step ``fused_train_steps`` window): world 1 over NCCL gives
stages 1-3 the losses and fp32 masters of stage 0 bit for bit, each window
with no synchronising call (``set_sync_debug_mode("error")``); two ranks
sharing the card over gloo (which takes every collective of the port on
CUDA tensors) at stage 3 over ``{fsdp: 2}`` and stage 2 over
``{data: 2}`` stay within tests/test_torch_zero.py's bf16 tolerance of the
single-process stage 0, each rank holding half the state; K7 on a shard at
a 256-byte-aligned offset equals its plain version. The ranks are spawned
processes joined through a ``file://`` store; the pytest process starts no
process group.

This file imports neither ``jax`` nor ``deepspeed_tpu``; on the card run
it with ``python -m pytest --noconftest -q tests/test_torch_zero_cuda.py``."""

import json
import os
import tempfile

import pytest
import torch

pytestmark = pytest.mark.cuda

LR = 1e-3
ROWS, SEQ = 2, 64
RMS_TOL, MAX_TOL, LOSS_RTOL = 2.0 ** -4, 2.0, 2.0 ** -7  # tests/test_torch_zero.py's bf16
K7_ULPS = 2


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks train on the card")
    return torch.device("cuda")


def _run(stage, mesh, check_sync=False):
    """3 steps and a 2-step window from seed 0; losses, each parameter's
    whole fp32 master (on the host) and the flat state's bytes."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    from deepspeed_tpu_torch.models.llama import LlamaConfig, init_llama_for_causal_lm
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    reset_mesh_context()
    cfg = LlamaConfig.tiny(hidden_size=256, intermediate_size=512, num_attention_heads=2,
                           num_key_value_heads=1, ce_chunk_size=128, remat=True,
                           remat_policy="dots_saveable")
    model = init_llama_for_causal_lm(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    config = {"train_batch_size": ROWS, "bf16": {"enabled": True},
              "optimizer": {"type": "AdamW", "params": {"lr": LR}},
              "zero_optimization": {"stage": stage}}
    if mesh:
        config["mesh"] = mesh
    eng = deepspeed_tpu_torch.initialize(model=model, config=config)[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    data = torch.randint(0, 256, (5, ROWS, SEQ), generator=gen, device="cuda")
    fo.adam_step_.launches = 0
    losses, fetch = [], eng._fetch
    for i in range(3):
        loss = eng.forward(data[i], labels=data[i])
        eng.backward(loss)
        eng.step()
        losses.append(loss.item())

    def outside(x):
        torch.cuda.set_sync_debug_mode(0)
        return fetch(x)

    eng._fetch = outside
    if check_sync:
        torch.cuda.set_sync_debug_mode("error")
    try:
        losses += eng.fused_train_steps(data[3:], labels=data[3:]).tolist()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    masters = {k: v.cpu() for k, v in eng.full_master_params().items()}
    return {"losses": losses, "masters": masters, "state": eng.state_bytes(),
            "k7_launches": fo.adam_step_.launches}


def _world1(rank, store, out):
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1)
    runs = {stage: _run(stage, None, check_sync=True) for stage in (0, 1, 2, 3)}
    ok = {f"stage{s}": runs[s]["losses"] == runs[0]["losses"] and all(
        torch.equal(runs[s]["masters"][k], v) for k, v in runs[0]["masters"].items())
        for s in (1, 2, 3)}
    ok["k7"] = all(r["k7_launches"] == 5 for r in runs.values())
    dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(ok, f)


def _two_ranks(rank, store, out, ref_path):
    from deepspeed_tpu_torch import comm
    torch.cuda.set_device(0)
    comm.init_distributed(dist_backend="gloo", init_method=f"file://{store}", rank=rank,
                          world_size=2)
    ref = torch.load(ref_path)
    res = {}
    for name, stage, mesh in (("stage3", 3, {"fsdp": 2}), ("stage2", 2, {"data": 2})):
        run = _run(stage, mesh)
        diffs = torch.cat([(run["masters"][k] - v).reshape(-1) for k, v in
                           ref["masters"].items()])
        path = 5 * LR
        rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"]))
        res[name] = {"losses": rel <= LOSS_RTOL,
                     "masters": float(diffs.square().mean().sqrt()) <= RMS_TOL * path
                     and float(diffs.abs().max()) <= MAX_TOL * path,
                     "half": 2 * run["state"]["masters"] - ref["state"]["masters"] < 4 * 1024
                     and run["state"]["m"] == run["state"]["masters"],
                     "k7": run["k7_launches"] == 5}
    import torch.distributed as dist
    dist.destroy_process_group()
    with open(f"{out}.rank{rank}", "w") as f:
        json.dump(res, f)


def _spawn(fn, nprocs, *args):
    import torch.multiprocessing as mp
    mp.start_processes(fn, args=args, nprocs=nprocs, start_method="spawn")


def _single(rank, out):
    torch.cuda.set_device(0)
    torch.save(_run(0, None), out)


def test_world1_nccl_stages_bit_equal_to_stage0(cuda_device):
    tmp = tempfile.mkdtemp()
    out = os.path.join(tmp, "out.json")
    _spawn(_world1, 1, os.path.join(tmp, "store"), out)
    with open(out) as f:
        assert json.load(f) == {"stage1": True, "stage2": True, "stage3": True, "k7": True}


def test_two_ranks_share_the_card_over_gloo(cuda_device):
    tmp = tempfile.mkdtemp()
    ref = os.path.join(tmp, "ref.pt")
    _spawn(_single, 1, ref)
    out = os.path.join(tmp, "out")
    _spawn(_two_ranks, 2, os.path.join(tmp, "store"), out, ref)
    for rank in range(2):
        with open(f"{out}.rank{rank}") as f:
            res = json.load(f)
        for name in ("stage3", "stage2"):
            assert res[name] == {"losses": True, "masters": True, "half": True, "k7": True}, (
                rank, name, res)


@pytest.mark.parametrize("offset", [64, 64 * 1001])
def test_k7_on_a_shard_at_an_aligned_offset(cuda_device, offset):
    """K7 on views that start ``offset`` elements into their buffers, as a
    rank's shard does, against the plain version on the same inputs."""
    from deepspeed_tpu_torch.ops import fused_optimizer as fo
    n = 100_000
    gen = torch.Generator(device="cuda").manual_seed(1)

    def buf(scale):
        b = torch.zeros(offset + n, device="cuda")
        b[offset:].normal_(0, scale, generator=gen)
        return b[offset:]

    p, g, m = buf(0.02), buf(1e-3), buf(1e-4)
    v = buf(1e-4)
    v.square_()
    lr, step = fo.device_scalar(1e-3, "cuda"), fo.device_scalar(3.0, "cuda")
    ref = fo.adam_update_reference(p, g, m, v, lr, step, weight_decay=0.01)
    fo.adam_step_(p, g, m, v, lr, step, weight_decay=0.01)
    for got, want in zip((p, m, v), ref):
        assert ulp_distance(got, want) <= K7_ULPS


def ulp_distance(x, ref) -> int:
    """The largest distance in fp32 units in the last place, both signs
    ordered on one integer line."""
    def key(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i >= 0, i, -(1 << 31) - i)

    return int((key(x) - key(ref)).abs().max().item())
