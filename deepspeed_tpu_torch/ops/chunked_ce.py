"""Chunked unembed + cross-entropy (port of
``deepspeed_tpu/ops/chunked_ce.py``).

The ``[tokens, vocab]`` logits are never held whole: the forward sweeps
vocab chunks with a running logsumexp and the gold logit (``_fwd_sweep
:87``), the backward sweeps them again, rebuilding each chunk's softmax
from the saved lse and adding into ``dx`` and an fp32 ``dw`` (``_ce_bwd
:122``). The JAX op holds no Pallas kernel: each chunk is an XLA product,
so here each is a plain ``torch`` product, with the JAX numerics: operands
in ``compute_dtype`` (bf16 on the training path) and fp32 accumulation and
output (``matmul_fp32``), columns past the vocab masked to ``-inf`` (the
last chunk is the ragged remainder; the JAX op pads it to the chunk width
and masks the padding, which gives the same sums), ``dw`` built in fp32
and cast to ``w``'s dtype at the end. Gemma-2's final logit softcap
``cap * tanh(l / cap)`` is applied to each chunk's fp32 logits, and the
backward chains through it by ``1 - tanh^2`` (``_chunk_logits :50-67``,
``_ce_bwd :137-140``). The two sweeps run inside
``record_function`` ranges (``chunked_ce_forward``/``_backward``) so a
``torch.profiler`` trace attributes their kernels.
"""

import torch
from torch.overrides import handle_torch_function, has_torch_function
from torch.profiler import record_function


def matmul_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 2-D operands of one dtype with an fp32 result: fp32
    accumulation and output (XLA's ``preferred_element_type=float32``).
    On CUDA a bf16 pair runs as a bf16 product with an fp32 output; on the
    CPU the operands are widened to fp32 first, which gives the same
    products, since a product of two bf16 values is exact in fp32."""
    if a.dtype == torch.float32:
        return a @ b.float()
    if a.is_cuda:
        return torch.mm(a, b.to(a.dtype), out_dtype=torch.float32)
    return a.float() @ b.float()


def _chunk_logits(x, w, c0, c1, compute_dtype, softcap=None):
    """fp32 logits of vocab columns [c0, c1), after the softcap, and the
    softcap's tanh (None without one)."""
    lc = matmul_fp32(x.to(compute_dtype), w[:, c0:c1].to(compute_dtype))
    if softcap is None:
        return lc, None
    t = torch.tanh(lc / softcap)
    return softcap * t, t


def _chunks(V, chunk):
    return [(c0, min(c0 + chunk, V)) for c0 in range(0, V, chunk)]


def _fwd_sweep(x, w, targets, chunk, compute_dtype, softcap):
    """Per-token (nll, lse), both fp32 ``[T]``."""
    T = x.shape[0]
    m = torch.full((T, ), float("-inf"), dtype=torch.float32, device=x.device)
    s = torch.zeros(T, dtype=torch.float32, device=x.device)
    gold = torch.zeros(T, dtype=torch.float32, device=x.device)
    for c0, c1 in _chunks(w.shape[1], chunk):
        lc, _ = _chunk_logits(x, w, c0, c1, compute_dtype, softcap)
        m_new = torch.maximum(m, lc.amax(-1))
        # exp(-inf - -inf) guard: a first chunk must not poison s
        corr = torch.exp(torch.where(torch.isinf(m), torch.zeros_like(m),
                                     m - m_new))
        s = s * corr + torch.exp(lc - m_new[:, None]).sum(-1)
        m = m_new
        hit = (targets >= c0) & (targets < c1)
        idx = (targets - c0).clamp(0, c1 - c0 - 1)
        gold = gold + torch.where(hit, lc.gather(1, idx[:, None])[:, 0],
                                  torch.zeros_like(gold))
    lse = m + torch.log(s)
    return lse - gold, lse


def _bwd_sweep(x, w, targets, lse, g, chunk, compute_dtype, softcap):
    """(dx, dw) of the per-token NLL for its cotangent ``g``."""
    T, H = x.shape
    V = w.shape[1]
    g = g.float()
    dx = torch.zeros(T, H, dtype=torch.float32, device=x.device)
    dw = torch.zeros(H, V, dtype=torch.float32, device=x.device)
    xt = x.to(compute_dtype).t()
    for c0, c1 in _chunks(V, chunk):
        lc, t = _chunk_logits(x, w, c0, c1, compute_dtype, softcap)
        dl = torch.exp(lc - lse[:, None])
        # -1 at each gold column in this chunk; adding -0.0 leaves a value's
        # bits, so no row is picked out by a host-side index (no sync)
        hit = (targets >= c0) & (targets < c1)
        idx = (targets - c0).clamp(0, c1 - c0 - 1)
        dl.scatter_add_(1, idx[:, None], torch.where(hit, -1.0, -0.0)[:, None])
        dl = dl * g[:, None]
        if t is not None:  # d/dl of cap * tanh(l / cap) is 1 - tanh^2
            dl = dl * (1.0 - t * t)
        dlc = dl.to(compute_dtype)
        dx += matmul_fp32(dlc, w[:, c0:c1].to(compute_dtype).t())
        dw[:, c0:c1] = matmul_fp32(xt, dlc)
    return dx.to(x.dtype), dw.to(w.dtype)


class _ChunkedUnembedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, chunk, compute_dtype, softcap):
        with record_function("chunked_ce_forward"):
            nll, lse = _fwd_sweep(x, w, targets, chunk, compute_dtype, softcap)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.opts = (chunk, compute_dtype, softcap)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        with record_function("chunked_ce_backward"):
            dx, dw = _bwd_sweep(x, w, targets, lse, g, *ctx.opts)
        return dx, dw, None, None, None, None


def chunked_unembed_ce(x, w, targets, chunk: int, compute_dtype=torch.bfloat16,
                       softcap=None):
    """Per-token NLL of ``softmax(softcap(x @ w))`` without materializing
    the logits. ``x`` [T, H], ``w`` [H, V], ``targets`` [T] int (callers
    mask ignore_index outside), ``softcap`` Gemma-2's final logit cap or
    None. Returns nll [T] fp32, differentiable in x and w. The call takes
    part in ``__torch_function__`` (a mode sees ``w`` read here: the
    scheduled ZeRO-3 store, ``runtime/zero3_schedule.py``). The JAX op's
    bias and logit scale wait for the first ported model that sets them."""
    if has_torch_function((x, w)):  # a mode that reads the weight sees this call
        return handle_torch_function(chunked_unembed_ce, (x, w), x, w, targets, chunk,
                                     compute_dtype=compute_dtype, softcap=softcap)
    if softcap is not None and not softcap > 0:
        raise ValueError(f"chunked_unembed_ce: softcap must be positive, got {softcap!r}")
    return _ChunkedUnembedCE.apply(x, w, targets.long(), int(chunk), compute_dtype,
                                   None if softcap is None else float(softcap))


def causal_targets(labels, ignore_index: int = -100):
    """``(targets, weights)`` of the causal-LM CE: ``labels`` shifted by
    one, each ``ignore_index`` target set to 0 with weight 0, the rest
    weight 1. The one rule of which labels a token-mean loss averages over:
    the count it divides by is ``weights.sum()``."""
    tg = labels[:, 1:]
    ignored = tg == ignore_index
    return torch.where(ignored, torch.zeros_like(tg), tg), (~ignored).float()


def chunked_cross_entropy_loss(x, w, labels, chunk: int, ignore_index: int = -100,
                               compute_dtype=torch.bfloat16, softcap=None):
    """Token-mean causal-LM CE (shift-by-one, ``ignore_index``) over a
    streamed unembed. ``x`` [B, S, H], ``labels`` [B, S]."""
    B, S, H = x.shape
    xs = x[:, :-1].reshape(B * (S - 1), H)
    tg, mask = (t.reshape(B * (S - 1)) for t in causal_targets(labels, ignore_index))
    nll = chunked_unembed_ce(xs, w, tg, chunk, compute_dtype, softcap)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
