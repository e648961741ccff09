"""On-device token sampling for the serving engine (port of the
non-speculative half of ``deepspeed_tpu/ops/sampling.py``, ``:53-183``).

The sampler the engine's numpy oracle (``InferenceEngineV2.
_sample_with_logprob`` / ``process_logits``) runs row by row, as batched
tensor ops over the ragged row layout ``[S, vocab]``, so that it runs
inside the captured decode step of the fused window (``model.py
fused_decode``) and, for per-step ticks, as one batched call per tick.
Sampling reaches no Pallas kernel in the JAX package (plain XLA), so it
stays PyTorch tensor ops here.

Semantics, as in the JAX module:

- ``temperature <= 0``: greedy over the RAW logits; logprob from the raw
  softmax.
- ``top_k``: kth-largest VALUE threshold (ties at the kth value survive);
  ``top_k <= 0`` or ``>= vocab`` disables.
- ``top_p``: nucleus over the temperature-scaled, top-k-filtered logits
  with the ``cumsum(p) - p < top_p`` keep rule in the oracle's tie order
  (a stable ascending sort, reversed); ``top_p <= 0`` degenerates to
  greedy over the filtered logits; ``top_p >= 1`` disables.
- Gumbel-max sampling, ``argmax(logits + G)``; the selected token's
  logprob is taken on the filtered distribution.
- the CTRL repetition penalty over a boolean history mask ``[S, vocab]``,
  then eos masking (``min_new_tokens``), before temperature.

The random numbers. The JAX module carries one threefry key per sequence
and splits it once per sampled token. ``torch.Generator`` cannot
reproduce those chains, so ``sample_core`` takes its Gumbel noise as an
argument, and :func:`gumbel_noise` makes it on the device as a pure
function of (the sequence's seed, the index of the token being sampled,
the column): a counter-based integer hash that reads and advances no
generator state. A sequence's stream therefore depends on neither the
path (per-step tick or fused window), the batch it rides in, nor the
window size, and a replay after eviction continues the same stream
without a fast-forward step.
"""

import torch

NEG_INF = float("-inf")

_M32 = 0xFFFFFFFF
# odd multipliers below 2**31, so that a 32-bit value times one fits in an
# int64 without overflow
_MUL1, _MUL2, _GOLDEN = 0x7FEB352D, 0x5BD1E995, 0x61C88647


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche mix (xorshift-multiply rounds) of the low 32
    bits of an int64 tensor (or a Python int), in int64 arithmetic."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * _MUL1) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor, vocab: int) -> torch.Tensor:
    """Standard Gumbel noise ``[S, vocab]`` fp32 for sampling, per row, the
    token at index ``positions[s]`` of the sequence seeded ``seeds[s]``
    (both ``[S]`` integer tensors): ``-log(-log(u))`` with ``u`` in (0, 1)
    from 23 bits of a hash of (seed, position, column), on the tensors'
    device."""
    row = _mix32(_mix32(seeds.long()) ^ _mix32(positions.long() + _GOLDEN))
    cols = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    h = _mix32(_mix32(row[:, None] ^ ((cols * _GOLDEN) & _M32)))
    u = ((h >> 9).float() + 0.5) * 2.0 ** -23  # 24 significant bits: exact
    return -torch.log(-torch.log(u))


def sequence_seed(seed: int, uid: int) -> int:
    """The per-sequence seed of request ``uid`` under ``generate``'s
    ``seed`` (the JAX engine folds ``uid`` into ``PRNGKey(seed)``)."""
    return _mix32((int(seed) & _M32) ^ _mix32(int(uid) + _MUL2))


def apply_repetition_penalty(logits, seen_mask, penalties):
    """CTRL repetition penalty, batched: where ``seen_mask`` is True,
    positive logits divide by the row's penalty and negative ones multiply.
    logits [S, V] f32, seen_mask [S, V] bool, penalties [S] f32."""
    p = penalties[:, None]
    penalized = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(seen_mask, penalized, logits)


def mask_eos(logits, eos_ids, block):
    """Set the eos column to -inf per row where ``block`` is True.
    ``eos_ids`` [S] int (< 0 = no eos id); block [S] bool."""
    cols = torch.arange(logits.shape[-1], dtype=torch.int64, device=logits.device)[None, :]
    eos = eos_ids.long()
    hit = (cols == eos[:, None]) & block[:, None] & (eos >= 0)[:, None]
    return torch.where(hit, NEG_INF, logits)


def filter_top_k(logits, top_ks):
    """kth-largest VALUE threshold per row (ties at the kth value are
    kept). ``top_ks`` [S] int; ``<= 0`` or ``>= vocab`` disables the row's
    filter."""
    V = logits.shape[-1]
    srt = torch.sort(logits, dim=-1, descending=True).values
    kk = top_ks.long().clamp(1, V)
    kth = srt.gather(-1, (kk - 1)[:, None])
    on = ((top_ks > 0) & (top_ks < V))[:, None]
    return torch.where(on & (logits < kth), NEG_INF, logits)


def filter_top_p(logits, top_ps):
    """Nucleus filter per row: keep the smallest set of tokens whose
    softmax mass reaches ``top_p`` (``cumsum(p) - p < top_p``; the
    highest-prob token always survives), in the oracle's tie order: a
    stable ascending sort, reversed. Rows with ``top_p <= 0`` or ``>= 1``
    pass through."""
    asc = torch.sort(logits, dim=-1, stable=True).indices
    order = asc.flip(-1)
    srt = logits.gather(-1, order)
    p = torch.exp(srt - srt[:, :1])  # srt[:, 0] is the row max
    p = p / p.sum(-1, keepdim=True)
    keep_sorted = (torch.cumsum(p, dim=-1) - p) < top_ps[:, None]
    keep = torch.zeros_like(keep_sorted).scatter_(-1, order, keep_sorted)
    on = ((top_ps > 0.0) & (top_ps < 1.0))[:, None]
    return torch.where(on & ~keep, NEG_INF, logits)


def selected_logprob(logits, toks):
    """log p(tok) under softmax(logits), per row; filtered (-inf) entries
    carry no mass."""
    m = logits.max(-1).values
    lse = m + torch.log(torch.exp(logits - m[:, None]).sum(-1))
    return logits.gather(-1, toks.long()[:, None])[:, 0] - lse


def sample_core(logits, noise, temps, top_ks, top_ps, *, want_logprobs: bool):
    """One sampling step over a batch of rows, shared by the per-step tick
    and the fused window. logits [S, V] (promoted to fp32), noise [S, V]
    fp32 Gumbel noise (:func:`gumbel_noise`), temps/top_ps [S] f32, top_ks
    [S] int. Returns ``(toks [S] int32, logprobs [S] f32)``; the logprobs
    are zeros when ``want_logprobs`` is False."""
    raw = logits.float()
    temps_safe = torch.where(temps > 0, temps, torch.ones_like(temps))
    scaled = raw / temps_safe[:, None]
    filt = filter_top_p(filter_top_k(scaled, top_ks), top_ps)
    tok_sampled = torch.argmax(filt + noise, dim=-1)
    tok_greedy = torch.argmax(raw, dim=-1)
    # top_p <= 0: the degenerate nucleus, greedy over the filtered logits
    tok_degenerate = torch.argmax(filt, dim=-1)
    greedy = temps <= 0
    degenerate = ~greedy & (top_ps <= 0.0)
    toks = torch.where(greedy, tok_greedy,
                       torch.where(degenerate, tok_degenerate, tok_sampled)).int()
    if want_logprobs:
        lps = selected_logprob(torch.where(greedy[:, None], raw, filt), toks)
    else:
        lps = torch.zeros(raw.shape[0], dtype=torch.float32, device=raw.device)
    return toks, lps


def apply_logit_controls(logits, *, seen_mask=None, penalties=None,
                         eos_ids=None, block_eos=None):
    """Pre-sampling logit controls: the repetition penalty over the history
    mask, then eos masking. None skips a control."""
    logits = logits.float()
    if seen_mask is not None:
        logits = apply_repetition_penalty(logits, seen_mask, penalties)
    if block_eos is not None:
        logits = mask_eos(logits, eos_ids, block_eos)
    return logits


def sample_step(logits, noise, temps, top_ks, top_ps, seen_mask, penalties,
                eos_ids, block_eos, *, want_logprobs: bool, use_penalty: bool,
                use_eos_mask: bool):
    """Controls and sampling for one batched per-step tick; the control
    operands the flags leave off may be None."""
    ctrl = apply_logit_controls(
        logits,
        seen_mask=seen_mask if use_penalty else None,
        penalties=penalties if use_penalty else None,
        eos_ids=eos_ids if use_eos_mask else None,
        block_eos=block_eos if use_eos_mask else None)
    return sample_core(ctrl, noise, temps, top_ks, top_ps, want_logprobs=want_logprobs)
