"""On-device token sampling and speculative verification for the serving
engine (port of ``deepspeed_tpu/ops/sampling.py``).

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

Speculative decoding (the JAX ``:185-329``): ``ngram_draft_ring`` drafts
by prompt lookup from a per-row history ring on the device,
``spec_verify_window`` verifies one window (argmax match for greedy rows,
rejection sampling against the point-mass drafts for sampled ones) and
``ring_append`` adds the emitted tokens to the ring. As ``sample_core``
takes its noise, ``spec_verify_window`` takes its draws: ``d`` uniforms
and one Gumbel row per row, which :func:`spec_draws` makes from the same
kind of hash, keyed by (the sequence's seed, its output count at the
window's start, the draft index or column) in a domain of its own, so
that they never repeat a token draw's noise. The fused window and the
per-token verify draw the same numbers, so they give one stream.
"""

import torch

NEG_INF = float("-inf")

_M32 = 0xFFFFFFFF
# odd multipliers below 2**31, so that a 32-bit value times one fits in an
# int64 without overflow
_MUL1, _MUL2, _GOLDEN = 0x7FEB352D, 0x5BD1E995, 0x61C88647
# the speculative draws' domains: a window's uniforms and its Gumbel row
_SPEC_UNIFORM, _SPEC_GUMBEL = 0x2545F491, 0x68E31DA4


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


def _uniform_from(h: torch.Tensor) -> torch.Tensor:
    """fp32 uniforms in (0, 1) from 23 bits of each hash value (exact)."""
    return ((h >> 9).float() + 0.5) * 2.0 ** -23


def spec_draws(seeds: torch.Tensor, n_out: torch.Tensor, d: int, vocab: int):
    """The random draws of one speculative window per row, for the
    sequence seeded ``seeds[s]`` whose window starts at output count
    ``n_out[s]``: ``(uniforms [S, d], gumbel [S, vocab])`` fp32, the accept
    tests' coin flips and the correction token's noise."""
    pos = _mix32(n_out.long() + _GOLDEN)
    row_u = _mix32(_mix32(seeds.long() ^ _SPEC_UNIFORM) ^ pos)
    row_g = _mix32(_mix32(seeds.long() ^ _SPEC_GUMBEL) ^ pos)
    j = torch.arange(d, dtype=torch.int64, device=seeds.device)
    u = _uniform_from(_mix32(_mix32(row_u[:, None] ^ ((j * _GOLDEN) & _M32))))
    cols = torch.arange(vocab, dtype=torch.int64, device=seeds.device)
    g = _uniform_from(_mix32(_mix32(row_g[:, None] ^ ((cols * _GOLDEN) & _M32))))
    return u, -torch.log(-torch.log(g))


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


# ---------------------------------------------------------------------------
# speculative decoding: drafting, verification, the history ring
#
# Prompt-lookup drafts are point masses, so speculative rejection sampling
# accepts draft t with the target probability p(t), and at the first
# rejection samples from p with the rejected token removed. Greedy rows
# (temperature <= 0) verify by exact argmax match.
# ---------------------------------------------------------------------------


def ngram_draft_ring(hist, hist_len, ngrams, max_drafts, *, max_ngram: int, d: int):
    """Prompt-lookup drafting over per-row history rings (the JAX
    ``ngram_draft_ring``). ``hist`` [S, W] int32 holds the trailing W
    tokens of each row's history, logical position p in slot ``p % W``;
    ``hist_len`` [S] the history's length; ``ngrams``/``max_drafts`` [S]
    per row; ``max_ngram`` and the draft width ``d`` static. The most
    recent earlier occurrence of the trailing n-gram (not the trivial self
    match) proposes the tokens that followed it. Returns ``(drafts [S, d]
    int32, dlen [S] int32)``, ``dlen`` the real leading drafts (0: no
    match)."""
    S, W = hist.shape
    dev = hist.device
    i32 = dict(dtype=torch.int32, device=dev)
    hist_len, ngrams, max_drafts = hist_len.int(), ngrams.int(), max_drafts.int()
    offs = torch.arange(W, **i32)[None, :]                       # 0 = most recent
    s = hist_len[:, None] - ngrams[:, None] - 1 - offs            # [S, W] match starts
    oldest = (hist_len - W).clamp_min(0)
    valid = s >= oldest[:, None]
    jj = torch.arange(max_ngram, **i32)
    pat_pos = hist_len[:, None] - ngrams[:, None] + jj[None, :]   # [S, G]
    pat = hist.gather(1, (pat_pos % W).long())
    cand_pos = s[:, :, None] + jj[None, None, :]                  # [S, W, G]
    cand = hist.gather(1, (cand_pos % W).long().view(S, -1)).view(S, W, max_ngram)
    eq = (cand == pat[:, None, :]) | (jj[None, None, :] >= ngrams[:, None, None])
    ok_row = (hist_len > ngrams) & (max_drafts > 0) & (ngrams > 0)
    match = valid & eq.all(-1) & ok_row[:, None]                  # [S, W]
    any_match = match.any(1)
    s_off = torch.argmax(match.int(), dim=1).int()                # first: most recent
    start = hist_len - 1 - s_off
    dpos = start[:, None] + torch.arange(d, **i32)[None, :]
    drafts = hist.gather(1, (dpos % W).long())
    dlen = torch.where(any_match, torch.minimum(max_drafts, s_off + 1),
                       torch.zeros_like(s_off))
    return drafts.int(), dlen.int()


def spec_verify_window(window_logits, drafts, dlen, uniforms, gumbel, temps, top_ks, top_ps,
                       *, d: int):
    """Verify one speculative window per row and emit its accepted drafts
    and the correction (or bonus) token (the JAX ``spec_verify_window``,
    with its draws as arguments). ``window_logits`` [S, 1+d, V] are the
    next-token logits at the fed positions; ``drafts`` [S, d] with
    ``dlen`` [S] real entries; ``uniforms`` [S, d] and ``gumbel`` [S, V]
    the window's draws (:func:`spec_draws`); temps/top_ks/top_ps as in
    ``sample_core``. Returns ``(out [S, 1+d] int32, n_emit [S] int32)``:
    row i emits ``out[i, :n_emit[i]]``, and ``n_emit - 1`` drafts were
    accepted. Greedy rows verify by argmax and read no draws."""
    S, Np1, V = window_logits.shape
    dev = window_logits.device
    raw = window_logits.float()
    temps_safe = torch.where(temps > 0, temps, torch.ones_like(temps))
    flat = raw.reshape(S * Np1, V)
    scaled = flat / temps_safe.repeat_interleave(Np1)[:, None]
    filt = filter_top_p(filter_top_k(scaled, top_ks.repeat_interleave(Np1)),
                        top_ps.repeat_interleave(Np1)).reshape(S, Np1, V)
    greedy = temps <= 0
    degenerate = ~greedy & (top_ps <= 0.0)
    g_tok = torch.argmax(raw, dim=-1).int()                        # [S, 1+d]
    deg_tok = torch.argmax(filt, dim=-1).int()
    drafts = drafts.int()
    lp_d = selected_logprob(filt[:, :d].reshape(S * d, V), drafts.reshape(S * d)).reshape(S, d)
    acc = torch.where(greedy[:, None], drafts == g_tok[:, :d],
                      torch.where(degenerate[:, None], drafts == deg_tok[:, :d],
                                  uniforms < torch.exp(lp_d)))
    dj = torch.arange(d, dtype=torch.int32, device=dev)[None, :]
    acc = acc & (dj < dlen[:, None])
    m = torch.cumprod(acc.int(), dim=1).sum(1).int()               # accepted prefix
    rows = torch.arange(S, device=dev)
    logit_m_raw = raw[rows, m.long()]
    logit_m_filt = filt[rows, m.long()]
    rejected = m < dlen
    rej_tok = drafts[rows, m.clamp_max(d - 1).long()]
    cols = torch.arange(V, dtype=torch.int32, device=dev)[None, :]
    resid = torch.where(rejected[:, None] & (cols == rej_tok[:, None]), NEG_INF, logit_m_filt)
    corr = torch.where(greedy, torch.argmax(logit_m_raw, dim=-1),
                       torch.where(degenerate, torch.argmax(logit_m_filt, dim=-1),
                                   torch.argmax(resid + gumbel, dim=-1))).int()
    jfull = torch.arange(Np1, dtype=torch.int32, device=dev)[None, :]
    drafts_pad = torch.cat([drafts, drafts[:, -1:]], dim=1)
    out = torch.where(jfull < m[:, None], drafts_pad, corr[:, None])
    return out.int(), m + 1


def greedy_verify_window(window_logits, drafts, dlen, *, d: int):
    """The greedy verify of a window with no sampling work (the fused
    window's greedy step, the JAX ``_fused_spec_decode_loop``'s greedy
    branch): the longest prefix of drafts equal to the argmax, then the
    argmax at the first mismatch. Returns ``(out [S, 1+d], n_emit [S])``
    as :func:`spec_verify_window` does for greedy rows."""
    S, Np1, _ = window_logits.shape
    dev = window_logits.device
    g_tok = torch.argmax(window_logits.float(), dim=-1).int()
    jw = torch.arange(Np1, dtype=torch.int32, device=dev)[None, :]
    drafts = drafts.int()
    acc = (drafts == g_tok[:, :d]) & (jw[:, :d] < dlen[:, None])
    m = torch.cumprod(acc.int(), dim=1).sum(1).int()
    corr = g_tok.gather(1, m.long()[:, None])[:, 0]
    drafts_pad = torch.cat([drafts, drafts[:, -1:]], dim=1)
    out = torch.where(jw < m[:, None], drafts_pad, corr[:, None])
    return out.int(), m + 1


def ring_append(hist, hist_len, toks, n):
    """Append ``toks[i, :n[i]]`` to row i's ring (the layout of
    :func:`ngram_draft_ring`), in place: the token of logical position p
    lands in slot ``p % W``; the entries past ``n`` leave their slots as
    they were. The append width must be at most W, so that the slots of
    one call are distinct. Returns ``(hist, hist_len + n)``."""
    S, W = hist.shape
    jj = torch.arange(toks.shape[1], dtype=torch.int32, device=hist.device)[None, :]
    idx = ((hist_len[:, None] + jj) % W).long()
    keep = hist.gather(1, idx)
    hist.scatter_(1, idx, torch.where(jj < n[:, None], toks.to(hist.dtype), keep))
    return hist, hist_len + n
