"""InferenceEngineV2 — ragged continuous-batching serving engine (port of
``deepspeed_tpu/inference/v2/engine_v2.py``; reference
``deepspeed/inference/v2/engine_v2.py:30``).

Same contract: ``put(uids, tokens)`` runs one ragged forward returning one
logits row per sequence; ``query``/``can_schedule`` expose the Dynamic
SplitFuse feasibility math; ``flush`` drops a sequence's KV; ``generate``
is the continuous-batching decode loop with admission under decode
headroom, chunked prefill and evict-and-replay, the logit controls
(min_new_tokens, repetition penalty, a host ``logits_processor``) and
stop sequences. Decoding runs the fused window (``fused_decode_steps``:
K steps with one host fetch, a captured CUDA graph replayed per step on
the card) where every live sequence has room for it, else one ragged
forward per step; sampling runs on the device (``ops/sampling``,
``sample_rows``), or in host numpy for plain greedy ticks and
``logits_processor`` requests.

Prefix caching (``enable_prefix_caching``; the JAX ``:163-175``,
``:243-356``, ``:473-500``): a new sequence's ``put`` adopts the longest
cached full-block prefix of its prompt read-only, forks a cached block
that it shares only in part by copying it (``model.cow_copy_block``, under
a transient pin on the source), and feeds only the rest; each sequence's
completed blocks join the cache as they fill, and at its flush its blocks
pass to the cache. Sliding-window models disable it
(``prefix_cache_report``).

Speculative decoding (``generate(speculative="prompt_lookup")``; the JAX
``:718-929``, ``:1079-1244``, ``:1640-1781``): drafts from the sequence's
own history (prompt lookup), verified in one forward with window logits
(``put(..., window_logits=True)``), greedily by argmax match or by
rejection sampling, the rejected tail rolled back in place
(``accept_drafts``/``accept_drafts_sampled``); or K windows at a time in
the fused speculative window (``fused_spec_decode_steps``, one captured
step replayed K times, one host fetch). ``score`` gives teacher-forced
log-probabilities in one forward, and ``num_return_sequences`` samples
each prompt N times, the prompt prefilled once into the prefix cache.
Not ported yet: multi-LoRA, fault injection, metrics, ``serialize``.
"""

import dataclasses
import logging
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ...models.llama import LlamaConfig, LlamaModel, init_llama
from ...ops import sampling as dsamp
from ...utils.device import resolve_device
from .config_v2 import RaggedInferenceEngineConfig
from .model import RaggedLlamaModel
from .ragged.ragged_manager import DSStateManager
from .ragged.ragged_wrapper import RaggedBatchWrapper, _bucket
from .ragged.sequence_descriptor import PlaceholderSequenceDescriptor
from .scheduling_utils import SchedulingError, SchedulingResult

logger = logging.getLogger(__name__)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@dataclasses.dataclass
class SampleSpec:
    """Per-sequence sampling parameters for the on-device sampler (the JAX
    engine's ``SampleSpec``): one row of a ``sample_rows`` call or one row
    of a sampled fused window. ``history`` (prompt + outputs) is read only
    when ``repetition_penalty != 1``; ``block_eos`` is a per-step tick's
    min_new gate, which the window derives each step from ``n_out`` and
    ``min_new``; ``seed`` is the sequence's noise seed and ``n_out`` the
    index of the token to sample next."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    eos_token_id: Optional[int] = None
    block_eos: bool = False
    history: Optional[List[int]] = None
    seed: int = 0
    want_logprobs: bool = False
    n_out: int = 0
    min_new: int = 0
    max_new: Optional[int] = None


@dataclasses.dataclass
class _InFlightWave:
    """A fused window enqueued on the device and not fetched yet: ``out``
    and ``lps`` are device tensors until ``fused_decode_harvest``. The
    sequences' host bookkeeping advanced at dispatch."""
    out: torch.Tensor            # [n_steps, n] int32
    lps: Optional[torch.Tensor]  # [n_steps, n] fp32 (sampled windows)
    seqs: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)  # each row's input token


@dataclasses.dataclass
class _InFlightSpecWave:
    """A fused speculative window enqueued and not fetched: how far each
    sequence advanced is a device result, so all its host bookkeeping
    waits for ``fused_spec_decode_harvest``."""
    seqs: list
    tokens: list
    out: torch.Tensor     # [n_steps, n, 1 + d] int32
    n_emit: torch.Tensor  # [n_steps, n] int32
    dlen: torch.Tensor    # [n_steps, n] int32


class InferenceEngineV2:

    def __init__(self, model: RaggedLlamaModel, engine_config: RaggedInferenceEngineConfig):
        self._config = engine_config
        self._model = model
        kv_config = model.kv_cache_config()
        self._batch = RaggedBatchWrapper(engine_config.state_manager,
                                         block_size=kv_config.block_size,
                                         device=model.device)
        prefix_caching = engine_config.enable_prefix_caching
        self._prefix_disable_reason = None if prefix_caching else "not_enabled"
        if prefix_caching and getattr(model.config, "sliding_window", None):
            logger.warning("prefix caching disabled: sliding-window models release "
                           "trailing KV blocks mid-sequence, which would free shared "
                           "prefix blocks")
            prefix_caching = False
            self._prefix_disable_reason = "sliding_window_model"
        self._state_manager = DSStateManager(engine_config.state_manager, kv_config,
                                             num_blocks=engine_config.num_kv_blocks,
                                             device=model.device,
                                             enable_prefix_caching=prefix_caching)
        self._model.set_state_manager(self._state_manager)
        self.last_spec_stats = {"drafted": 0, "accepted": 0}

    # ---- properties (reference engine_v2.py:47-66) ----

    @property
    def free_blocks(self) -> int:
        return self._state_manager.free_blocks

    def model(self) -> RaggedLlamaModel:
        return self._model

    def prefix_cache_report(self) -> dict:
        """The radix prefix cache's state and effectiveness: ``state``
        enabled, with ``PrefixKVCache.report()``'s counts, or disabled with
        the ``reason`` (``not_enabled``, ``sliding_window_model``)."""
        pc = self._state_manager.prefix_cache
        if pc is None:
            return {"state": "disabled", "reason": self._prefix_disable_reason or "not_enabled"}
        rep = pc.report()
        rep["state"] = "enabled"
        return rep

    # ---- serving (reference :107 put) ----

    def put(self, batch_uids: Iterable[int], batch_tokens: Iterable,
            do_checks: bool = True, window_logits: bool = False,
            defer_register=frozenset(), adopt_prefix: bool = True) -> torch.Tensor:
        """One ragged forward; returns fp32 logits [n_seqs_padded, vocab]
        on the model's device — row i is the next-token distribution for
        batch_uids[i].

        ``window_logits``: return ``[n_seqs_padded, N, vocab]``, the logits
        at every fed token (speculative verification), and leave the
        trailing-window KV frees to the caller, who frees once rollback
        has made ``seen_tokens`` true again. ``defer_register``: uids whose
        feed holds drafts; their prefix-cache registration waits until the
        caller has rolled back the rejected ones. ``adopt_prefix=False``
        feeds every token of a new sequence, cached or not."""
        batch_uids = list(batch_uids)
        batch_tokens = [np.asarray(t, dtype=np.int32).reshape(-1) for t in batch_tokens]

        if do_checks:
            token_lens = [t.size for t in batch_tokens]
            schedule_check = self.can_schedule(batch_uids, token_lens)
            if schedule_check != SchedulingResult.Success:
                raise SchedulingError(schedule_check)

        pc = self._state_manager.prefix_cache
        self._batch.clear()
        for i, (uid, tokens) in enumerate(zip(batch_uids, batch_tokens)):
            host_seq_desc = self._state_manager.get_sequence(uid)
            if pc is not None and adopt_prefix and host_seq_desc is None and tokens.size > 1:
                host_seq_desc, tokens = self._adopt(uid, tokens, pc)
            if host_seq_desc is None:
                host_seq_desc = self._state_manager.get_or_create_sequence(uid)
            if pc is not None:
                self._append_pending(host_seq_desc, tokens)
            batch_tokens[i] = tokens
            self._model.maybe_allocate_kv(host_seq_desc, tokens.size)
            host_seq_desc.pre_forward(tokens.size)
            self._batch.insert_sequence(host_seq_desc, tokens, do_checks=do_checks)

        batch = self._batch.finalize(
            total_slots=self._state_manager.kv_cache.num_blocks *
            self._state_manager.kv_cache.block_size)
        logits = self._model.forward(batch, window_logits=window_logits)

        for uid in batch_uids:
            seq = self._state_manager.get_sequence(uid)
            seq.post_forward()
            if pc is not None and uid not in defer_register:
                self._register_pending(seq)
            if not window_logits:
                self._model.maybe_free_kv(seq)
        return logits

    def _adopt(self, uid, tokens, pc):
        """A new sequence's adoption (the JAX ``put``'s ``:271-318``): the
        longest cached full-block prefix of all but the last token, and a
        copy-on-write fork of a cached block that it shares in part. The
        fork's source is pinned by ``match_fork`` until the copy is in the
        device's stream. Returns ``(descriptor or None, tokens to feed)``."""
        matched, chain_key, fork = pc.match_fork(tokens[:tokens.size - 1])
        dst = None
        if fork is not None:
            _src_key, src_block, fork_p = fork
            try:
                dst = self._state_manager.allocate_blocks(1)
            except SchedulingError:
                pc.release([src_block])  # the pool is spent: no fork
                fork = None
            else:
                self._model.cow_copy_block(src_block, int(dst[0]))
                pc.commit_fork(fork_p)
                pc.release([src_block])
        if not matched and fork is None:
            return None, tokens
        seq = self._state_manager.get_or_create_sequence(uid)
        if matched:
            seq.extend_kv_cache(matched)
        seq.adopted_blocks = set(matched)
        seq.chain_key = chain_key
        seq.chain_blocks = len(matched)
        skip = len(matched) * self._state_manager.block_size
        if fork is not None:
            seq.extend_kv_cache(dst)  # the private copy
            # the forked run joins the cache when this block completes
            seq.pending_tokens = np.asarray(tokens[skip:skip + fork_p], np.int32)
            skip += fork_p
        seq.pre_forward(skip)
        seq.post_forward()  # history: the cached prefix
        return seq, tokens[skip:]

    def score(self, batch_uids: Iterable[int], batch_tokens: Iterable, flush: bool = True):
        """Teacher-forced log-probabilities of new sequences: for each, an
        array of ``len(tokens) - 1`` values ``log p(tokens[j + 1] |
        tokens[:j + 1])`` from one ragged forward with window logits.
        ``flush=False`` keeps the sequences, so that ``put`` can decode on
        from them. Every token is fed, cached or not."""
        batch_uids = list(batch_uids)
        batch_tokens = [np.asarray(t, dtype=np.int32).reshape(-1) for t in batch_tokens]
        for uid in batch_uids:
            if self._state_manager.get_sequence(uid) is not None:
                raise ValueError(
                    f"score() expects NEW sequences (uid {uid} is live): "
                    "the first fed token's score would need the previous "
                    "step's logits")
        logits = self.put(batch_uids, batch_tokens, window_logits=True, adopt_prefix=False)
        out = []
        for i, toks in enumerate(batch_tokens):
            rows = logits[i, :toks.size - 1].double()
            lp = torch.log_softmax(rows, dim=-1)
            idx = torch.from_numpy(toks[1:].astype(np.int64)).to(rows.device)
            out.append(lp.gather(1, idx[:, None])[:, 0].cpu().numpy())
        if flush:
            for uid in batch_uids:
                self.flush(uid)
        return out

    def decode_finished(self, uid, outputs, max_new_tokens,
                        eos_token_id, stop) -> bool:
        """The retire predicate: output budget spent, eos emitted, a stop
        sequence hit, or the context ceiling reached."""
        seq = self._state_manager.get_sequence(uid)
        return (len(outputs) >= max_new_tokens
                or (eos_token_id is not None and outputs
                    and outputs[-1] == eos_token_id)
                or (bool(stop) and self.hit_stop(outputs, stop))
                or seq.seen_tokens + 1 > self._config.state_manager.max_context)

    @staticmethod
    def _append_pending(seq, tokens) -> None:
        """Stage fed tokens on the descriptor for prefix-cache
        registration."""
        seq.pending_tokens = np.concatenate(
            [seq.pending_tokens, np.asarray(tokens, np.int32)])

    def _register_pending(self, seq) -> None:
        """Register the sequence's newly completed full blocks with the
        prefix cache as a continuation of its chain: each block is hashed
        once over the sequence's life."""
        pc = self._state_manager.prefix_cache
        if pc is None:
            return
        bs = self._state_manager.block_size
        full = len(seq.pending_tokens) // bs
        if full:
            start = seq.chain_blocks
            seq.chain_key, _ = pc.register_from(seq.chain_key, seq.pending_tokens[:full * bs],
                                                seq.kv_blocks[start:start + full])
            seq.chain_blocks = start + full
            seq.pending_tokens = seq.pending_tokens[full * bs:]

    def _scrub_pending(self, uid) -> None:
        """Drop a scratch sequence's staged tokens, so that its flush
        registers nothing (warmup stays invisible to the cache)."""
        seq = self._state_manager.get_sequence(uid)
        if seq is not None:
            seq.pending_tokens = np.zeros(0, np.int32)

    # ---- scheduling feasibility (reference :158 query / :184 can_schedule) ----

    def query(self, uid: int, max_request_tokens: int, max_request_blocks: int) -> Tuple[int, int]:
        seq_desc = self._state_manager.get_sequence(uid)
        if seq_desc is None:
            if self._state_manager.n_tracked_sequences >= \
                    self._config.state_manager.max_tracked_sequences:
                return (0, 0)
            seq_desc = PlaceholderSequenceDescriptor()
        return self._model.get_kv_requirements(seq_desc, max_request_tokens, max_request_blocks)

    def can_schedule(self, uids: Iterable[int], lengths: Iterable[int]) -> SchedulingResult:
        uids, lengths = list(uids), list(lengths)
        cur_seqs = self._state_manager.n_tracked_sequences
        free_blocks = self._state_manager.free_blocks
        batch_len = 0

        if len(uids) > self._config.state_manager.max_ragged_sequence_count:
            return SchedulingResult.BatchSequenceLimitExceeded

        for uid, length in zip(uids, lengths):
            seq_desc = self._state_manager.get_sequence(uid)
            if seq_desc is None:
                cur_seqs += 1
                seq_desc = PlaceholderSequenceDescriptor()
            if seq_desc.seen_tokens + length > self._config.state_manager.max_context:
                return SchedulingResult.SequenceTokenLimitExceeded
            sched_len, sched_blocks = self._model.get_kv_requirements(seq_desc, length, free_blocks)
            if sched_len != length:
                return SchedulingResult.KVCacheLimitExceeded
            batch_len += length
            free_blocks -= sched_blocks

        if cur_seqs > self._config.state_manager.max_tracked_sequences:
            return SchedulingResult.EngineSequenceLimitExceeded
        if batch_len > self._config.state_manager.max_ragged_batch_size:
            return SchedulingResult.BatchTokenLimitExceeded
        return SchedulingResult.Success

    # ---- convenience decode loop (the MII surface over FastGen) ----

    @staticmethod
    def _sample_with_logprob(row: np.ndarray, temperature: float, rng,
                             top_k: int = 0, top_p: float = 1.0,
                             want_lp: bool = True) -> Tuple[int, float]:
        """Returns (token, logprob-of-token) under the temperature-scaled,
        top-k/top-p-filtered distribution (greedy logprobs come from the
        raw softmax). ``want_lp=False`` skips the O(vocab) softmax pass."""

        def lp_at(logits, tok):
            if not want_lp:
                return 0.0
            m = np.max(logits)
            return float(logits[tok] - m
                         - np.log(np.sum(np.exp(logits - m))))

        raw = row.astype(np.float64)
        if temperature <= 0:
            tok = int(np.argmax(raw))
            return tok, lp_at(raw, tok)
        logits = raw / temperature
        if top_k > 0 and top_k < logits.size:  # <=0 = disabled (vLLM style)
            kth = np.partition(logits, -top_k)[-top_k]
            logits = np.where(logits < kth, -np.inf, logits)
        if 0.0 < top_p < 1.0:
            # nucleus: keep the smallest set of tokens whose softmax mass
            # reaches top_p (the highest-prob token always survives)
            order = np.argsort(logits)[::-1]
            p = np.exp(logits[order] - np.max(logits))
            p = p / p.sum()
            keep = np.cumsum(p) - p < top_p
            drop = np.ones_like(logits, dtype=bool)
            drop[order[keep]] = False
            logits = np.where(drop, -np.inf, logits)
        elif top_p <= 0.0:
            tok = int(np.argmax(logits))  # degenerate nucleus = greedy
            return tok, lp_at(logits, tok)
        # Gumbel-max: argmax(logits + G) ~ softmax(logits) sample
        g = rng.gumbel(size=logits.shape)
        tok = int(np.argmax(logits + g))
        return tok, lp_at(logits, tok)

    @classmethod
    def _sample(cls, row: np.ndarray, temperature: float, rng,
                top_k: int = 0, top_p: float = 1.0) -> int:
        return cls._sample_with_logprob(row, temperature, rng, top_k, top_p,
                                        want_lp=False)[0]

    # ---- on-device sampling (ops/sampling; the numpy above stays the oracle) ----

    @staticmethod
    def _spec_statics(specs):
        """The static flags a batch of SampleSpecs resolves to: part of a
        step graph's key, so a plain window never pays for controls it
        does not use."""
        use_pen = any(s.repetition_penalty != 1.0 for s in specs)
        use_eos = any(s.eos_token_id is not None
                      and (s.block_eos or s.min_new > s.n_out) for s in specs)
        want_lp = any(s.want_logprobs for s in specs)
        return use_pen, use_eos, want_lp

    @staticmethod
    def _spec_arrays(specs, V: int, use_pen: bool, S: int = 0) -> dict:
        """The per-row control arrays of ``sample_rows`` and the sampled
        window, one row per spec, then inert padding rows up to ``S``
        (temperature 0, penalty 1, no eos)."""
        pad = [SampleSpec()] * max(0, S - len(specs))
        specs = list(specs) + pad
        arrays = {
            "temps": np.array([s.temperature for s in specs], np.float32),
            "top_ks": np.array([s.top_k for s in specs], np.int32),
            "top_ps": np.array([s.top_p for s in specs], np.float32),
            "penalties": np.array([s.repetition_penalty for s in specs], np.float32),
            "eos_ids": np.array([-1 if s.eos_token_id is None else int(s.eos_token_id)
                                 for s in specs], np.int32),
            "seeds": np.array([s.seed for s in specs], np.int64),
            "n_out": np.array([s.n_out for s in specs], np.int32),
            "min_new": np.array([s.min_new for s in specs], np.int32),
            "block_eos": np.array([s.block_eos for s in specs], bool),
            "seen_mask": None}
        if use_pen:
            mask = np.zeros((len(specs), V), bool)
            for i, s in enumerate(specs):
                if s.repetition_penalty != 1.0 and s.history:
                    mask[i, np.asarray(s.history, np.int64)] = True
            arrays["seen_mask"] = mask
        return arrays

    def sample_rows(self, batch_uids, rows, specs):
        """One batched on-device sampling call for a per-step tick's logits
        ``rows`` (``[>= n, vocab]`` on the model's device): the logit
        controls, then temperature/top-k/top-p Gumbel-max and the selected
        token's logprob, the same ops the sampled window runs, with each
        row's noise that of token ``spec.n_out`` of ``spec.seed``, so a
        request's stream is the same on either path. The rows are padded to
        the window's bucket, ``_bucket(n, floor=1)``, so that each
        reduction runs at the window's shape. One host fetch; returns
        ``(tokens, logprobs)`` lists of ``len(batch_uids)``."""
        n = len(list(batch_uids))
        S = _bucket(n, floor=1)
        if rows.shape[0] < S:
            rows = torch.cat([rows, rows.new_zeros(S - rows.shape[0], rows.shape[-1])])
        rows = rows[:S]
        use_pen, use_eos, want_lp = self._spec_statics(specs)
        a = self._spec_arrays(specs, rows.shape[-1], use_pen, S)
        dev = rows.device

        def t(x):
            return torch.from_numpy(x).to(dev)

        with torch.inference_mode():
            noise = dsamp.gumbel_noise(t(a["seeds"]), t(a["n_out"]), rows.shape[-1])
            toks, lps = dsamp.sample_step(
                rows, noise, t(a["temps"]), t(a["top_ks"]), t(a["top_ps"]),
                t(a["seen_mask"]) if use_pen else None, t(a["penalties"]), t(a["eos_ids"]),
                t(a["block_eos"]), want_logprobs=want_lp, use_penalty=use_pen,
                use_eos_mask=use_eos)
            both = torch.stack([toks, lps.view(torch.int32)])[:, :n].cpu().numpy()
        return [int(x) for x in both[0]], [float(x) for x in both[1].view(np.float32)]

    @staticmethod
    def process_logits(row, history, *, repetition_penalty: float = 1.0,
                       eos_token_id=None, block_eos: bool = False,
                       logits_processor=None):
        """Pre-sampling logit controls on a host row (HF-generate parity):
        the CTRL repetition penalty over the whole history, eos masked
        until ``min_new_tokens``, then a user processor. Returns ``row``
        itself when every control is off."""
        if (repetition_penalty == 1.0 and not block_eos
                and logits_processor is None):
            return row
        row = np.array(row, np.float32, copy=True)
        if repetition_penalty != 1.0:
            idx = np.unique(np.asarray(history, np.int64))
            vals = row[idx]
            row[idx] = np.where(vals > 0, vals / repetition_penalty,
                                vals * repetition_penalty)
        if block_eos and eos_token_id is not None:
            row[int(eos_token_id)] = -np.inf  # filtered tokens never win
        if logits_processor is not None:
            row = np.asarray(logits_processor(history, row), np.float32)
        return row

    # ---- the fused decode window (JAX engine_v2.py:390-430, :931-1077) ----

    def fused_window(self, uids, output_budgets, cap: int) -> int:
        """Largest power-of-two K <= ``cap`` that every sequence can absorb
        (remaining output budget and context room); < 2 means the per-step
        path should run. The power-of-two snap bounds the step graphs'
        keys."""
        sm = self._config.state_manager
        K = min(cap, min(output_budgets),
                min(sm.max_context - self._state_manager.get_sequence(u).seen_tokens
                    for u in uids))
        while K >= 2 and K & (K - 1):
            K &= K - 1
        return K

    def fused_partition(self, uids, output_budgets, cap: int):
        """Split a decode wave into ``(fusable, K, solo)``: ``fusable``
        keeps every sequence with >= 2 tokens of room (output budget and
        context), ``K`` is the largest power-of-two window <= ``cap`` they
        can all absorb, and ``solo`` holds the sequences within a token of
        retiring, which tick per-step."""
        sm = self._config.state_manager
        room = {u: min(b, sm.max_context - self._state_manager.get_sequence(u).seen_tokens)
                for u, b in zip(uids, output_budgets)}
        fusable = [u for u in uids if room[u] >= 2]
        solo = [u for u in uids if room[u] < 2]
        if not fusable:
            return [], 0, solo
        K = min(cap, min(room[u] for u in fusable))
        while K >= 2 and K & (K - 1):
            K &= K - 1
        if K < 2:  # cap itself forbids fusing: everything ticks per-step
            return [], 0, uids
        return fusable, K, solo

    def fused_spec_partition(self, uids, output_budgets, draft_tokens: int, cap: int):
        """The speculative :meth:`fused_partition`: a window can write ``1 +
        draft_tokens`` KV positions, so a row's room in windows is its
        context headroom over that width, and its output budget (a window
        emits at least one token; overshoot is trimmed at retirement).
        Returns ``(fusable, K, solo)``."""
        sm = self._config.state_manager
        w = 1 + max(1, int(draft_tokens))
        room = {u: min(b, (sm.max_context - self._state_manager.get_sequence(u).seen_tokens)
                       // w) for u, b in zip(uids, output_budgets)}
        fusable = [u for u in uids if room[u] >= 2]
        solo = [u for u in uids if room[u] < 2]
        if not fusable:
            return [], 0, solo
        K = min(cap, min(room[u] for u in fusable))
        while K >= 2 and K & (K - 1):
            K &= K - 1
        if K < 2:
            return [], 0, uids
        return fusable, K, solo

    def fused_decode_steps(self, batch_uids, last_tokens, n_steps: int, specs=None):
        """``n_steps`` decode steps of live sequences with one host fetch
        (``model.fused_decode``; on the card one captured step replayed
        ``n_steps`` times, the counterpart of the JAX ``lax.scan``).

        Host contract: every uid is live (has prefilled history) and has
        context room for ``n_steps`` more tokens; the KV blocks of all
        ``n_steps`` are allocated up front, and if they do not fit it
        raises ``SchedulingError`` with nothing allocated. The trailing-
        window frees are left to the caller, which trims to eos/stop and
        runs ``maybe_free_kv`` for the sequences that stay live.

        ``specs=None`` picks each step's argmax and returns int32 ``[n_seqs,
        n_steps]`` tokens. With one :class:`SampleSpec` per uid the logit
        controls and sampling run in each step, and the call returns
        ``(tokens, logprobs)``, both ``[n_seqs, n_steps]``."""
        return self.fused_decode_harvest(
            self.fused_decode_begin(batch_uids, last_tokens, n_steps, specs=specs))

    def fused_decode_begin(self, batch_uids, last_tokens, n_steps: int, specs=None):
        """The dispatch half of :meth:`fused_decode_steps`: checks and
        reserves the window's KV blocks, enqueues its steps without waiting
        for them and advances the sequences' host bookkeeping."""
        batch_uids = list(batch_uids)
        seqs = []
        for uid in batch_uids:
            seq = self._state_manager.get_sequence(uid)
            if seq is None or seq.seen_tokens == 0:
                raise ValueError(f"fused_decode_steps: uid {uid} is not a "
                                 "live prefilled sequence")
            seqs.append(seq)
        sm = self._config.state_manager
        if len(seqs) > sm.max_ragged_sequence_count:
            raise SchedulingError(SchedulingResult.BatchSequenceLimitExceeded)
        # feasibility before any allocation: the whole window must fit
        free = self._state_manager.free_blocks
        for seq in seqs:
            if seq.seen_tokens + n_steps > sm.max_context:
                raise SchedulingError(SchedulingResult.SequenceTokenLimitExceeded)
            n_fit, req = self._model.get_kv_requirements(seq, n_steps, free)
            if n_fit != n_steps:
                raise SchedulingError(SchedulingResult.KVCacheLimitExceeded)
            free -= req
        # each step's block-table width: the bucket a per-step put would
        # give it, from the blocks that step's position needs
        bs = self._model.kv_block_size
        first = [seq.cur_allocated_blocks for seq in seqs]
        lens = [seq.seen_tokens for seq in seqs]
        widths = [_bucket(max(max(a, (l + j) // bs + 1) for a, l in zip(first, lens)),
                          floor=1) for j in range(n_steps)]
        for seq in seqs:
            self._model.maybe_allocate_kv(seq, n_steps)
        B = _bucket(max(s.cur_allocated_blocks for s in seqs), floor=1)
        table = np.stack([s.block_table(B) for s in seqs])
        sampling = None
        if specs is not None:
            use_pen, use_eos, want_lp = self._spec_statics(specs)
            sampling = dict(self._spec_arrays(specs, self._model.config.vocab_size, use_pen),
                            want_logprobs=want_lp, use_penalty=use_pen, use_eos_mask=use_eos)
        tokens = [int(t) for t in last_tokens]
        out, lps = self._model.fused_decode(tokens, lens, table, n_steps, widths=widths,
                                            sampling=sampling)
        for seq in seqs:
            seq.pre_forward(n_steps)
            seq.post_forward()
        return _InFlightWave(out=out, lps=lps, seqs=seqs, tokens=tokens)

    def fused_decode_harvest(self, wave: _InFlightWave):
        """The fetch half of :meth:`fused_decode_steps`: one device-to-host
        copy of the window's tokens (and logprobs, by their bits) and the
        per-sequence contract, ``[n_seqs, n_steps]``. With prefix caching
        each sequence's fed tokens (its input token and every emitted one
        but the last) are staged for registration, which the caller runs
        after trimming."""
        if wave.lps is None:
            out, lps = wave.out.cpu().numpy().T, None
        else:
            both = torch.stack([wave.out, wave.lps.view(torch.int32)]).cpu().numpy()
            out, lps = both[0].T, both[1].view(np.float32).T
        if self._state_manager.prefix_cache is not None:
            for i, seq in enumerate(wave.seqs):
                self._append_pending(seq, np.concatenate([[wave.tokens[i]], out[i, :-1]]))
        return out if lps is None else (out, lps)

    def warmup(self, prefill_lens=(128, ), batch_sizes=(1, ), fused_windows=(),
               fused_sampled_windows=(), decode_context: int = 0, draft_tokens: int = 0,
               fused_spec_windows=(), spec_draft_tokens: int = 4,
               spec_draft_ngram: int = 2) -> int:
        """Run the paths serving will hit before the first request, so that
        no request pays for a first launch or a graph capture: a prefill at
        each length (and with ``draft_tokens`` a verify window of ``1 +
        draft_tokens`` tokens), the per-step decode at each batch size, and
        the step graphs of the fused window at each K of ``fused_windows``
        (greedy) and ``fused_sampled_windows`` (sampled, logprobs on) and
        of the fused speculative window at each K of
        ``fused_spec_windows`` (greedy and sampled) per batch size, on
        scratch sequences of ``decode_context`` tokens (the graphs' key
        holds the block-table width), which are flushed after. The scratch
        sequences neither adopt cached prefixes nor register their blocks.
        Returns the number of step graphs captured."""
        base = 1 << 28  # scratch uids clear of real ones
        for n in prefill_lens:
            self.put([base], [np.zeros(int(n), np.int32)], do_checks=False,
                     adopt_prefix=False, defer_register={base})
            self.put([base], [[0]], defer_register={base})
            if draft_tokens:
                self.put([base], [[0] * (1 + int(draft_tokens))], window_logits=True,
                         defer_register={base})
                self._state_manager.get_sequence(base).rollback(int(draft_tokens))
            self._scrub_pending(base)
            self.flush(base)
        for bs in batch_sizes:
            uids = list(range(base + 1, base + 1 + bs))
            scratch = frozenset(uids)
            for u in uids:
                self.put([u], [np.zeros(max(1, int(decode_context)), np.int32)],
                         do_checks=False, adopt_prefix=False, defer_register=scratch)
            self.put(uids, [[0]] * bs, defer_register=scratch)
            for K in fused_windows:
                self.fused_decode_steps(uids, [0] * bs, int(K))
            for K in fused_sampled_windows:
                self.fused_decode_steps(uids, [0] * bs, int(K),
                                        specs=[SampleSpec(temperature=1.0, want_logprobs=True)
                                               for _ in uids])
            for K in fused_spec_windows:
                # zero histories draft full windows (every n-gram matches)
                hists = [[0] * (self._state_manager.get_sequence(u).seen_tokens + 1)
                         for u in uids]
                for specs in (None, [SampleSpec(temperature=1.0) for _ in uids]):
                    self.fused_spec_decode_steps(uids, hists, int(K),
                                                 num_draft_tokens=spec_draft_tokens,
                                                 draft_ngram=spec_draft_ngram, specs=specs)
            for u in uids:
                self._scrub_pending(u)
                self.flush(u)
        return len(self._model._graphs)

    # ---- speculative decoding (JAX engine_v2.py:718-929, :1079-1244) ----

    def spec_ring_window(self, num_draft_tokens: int) -> int:
        """The history window of prompt-lookup drafting: the device ring
        holds at least one whole window plus a matchable n-gram, so small
        ``spec_history_window`` configs widen, and the per-token path's
        scan takes the same bound, so both see the same matches."""
        scfg = self._config.sampling
        d = max(1, int(num_draft_tokens))
        return max(int(scfg.spec_history_window), 2 * (1 + d) + int(scfg.spec_max_ngram))

    @staticmethod
    def prompt_lookup_draft(history, *, draft_ngram: int, max_tokens: int,
                            match_window: int = 0, match_cache=None):
        """Prompt-lookup drafting (Saxena): the tokens that followed the
        most recent earlier occurrence of the trailing ``draft_ngram``
        tokens. ``match_window`` > 0 bounds the candidates to the trailing
        window (the device ring's); ``match_cache`` (a per-request dict)
        keeps the last match's position, below which no later match can
        lie, so the scan stops there."""
        if max_tokens <= 0 or len(history) <= draft_ngram:
            return []
        pat = history[-draft_ngram:]
        lo = max(0, len(history) - match_window) if match_window > 0 else 0
        if match_cache is not None:
            p = match_cache.get("pos")
            if (p is not None and lo <= p <= len(history) - draft_ngram - 1
                    and history[p:p + draft_ngram] == pat):
                lo = p
        for s in range(len(history) - draft_ngram - 1, lo - 1, -1):
            if history[s:s + draft_ngram] == pat:
                if match_cache is not None:
                    match_cache["pos"] = s
                return [int(t) for t in history[s + draft_ngram:s + draft_ngram + max_tokens]]
        return []

    def _settle_window(self, uid, n_drafted: int, n_accepted: int) -> None:
        """After one verified window: roll the rejected drafts back (the
        history and the staged prefix-cache tokens) and run the deferred
        registration, now that ``seen_tokens`` is true."""
        seq = self._state_manager.get_sequence(uid)
        rejected = n_drafted - n_accepted
        if rejected:
            seq.rollback(rejected)
            if self._state_manager.prefix_cache is not None:
                seq.pending_tokens = seq.pending_tokens[:len(seq.pending_tokens) - rejected]
        if n_drafted:
            self._register_pending(seq)

    def accept_drafts(self, uid: int, draft, window_row):
        """Greedy verification of one sequence's window (``window_row``
        ``[N, vocab]`` logits, rows ``0..len(draft)`` valid, a tensor or an
        array; or, as ``[N]`` integers, their argmax): the longest prefix
        of the drafts equal to the argmax, then the argmax at the first
        mismatch (or the bonus token); the rejected tail rolls back in
        place. Returns ``(new_tokens, n_accepted)``."""
        k = len(draft)
        row = torch.as_tensor(window_row)
        top = (row if row.dim() == 1 else row[:k + 1].argmax(-1)).tolist()
        new_toks, m = [], 0
        for j in range(k + 1):
            t = int(top[j])
            new_toks.append(t)
            if j < k and draft[j] == t:
                m += 1
                continue
            break
        self._settle_window(uid, k, m)
        return new_toks, m

    def accept_drafts_sampled(self, uid: int, draft, window_rows, spec: SampleSpec,
                              d_static: int):
        """Rejection-sampling verification of one sequence's window for a
        sampled request (one row of :meth:`verify_sampled_windows`):
        ``window_rows`` ``[>= len(draft) + 1, vocab]`` logits. Returns
        ``(new_tokens, n_accepted)``."""
        rows = torch.as_tensor(window_rows, device=self._model.device).float()
        if rows.dim() == 1:
            rows = rows[None, :]
        return self.verify_sampled_windows([uid], [draft], rows[None], [spec], d_static)[0]

    def verify_sampled_windows(self, uids, drafts, window_logits, specs, d_static: int,
                               fed=None):
        """Rejection-sampling verification of sampled requests' windows, in
        one batched call at the fused window's shapes (``[bucket(n), 1 + d,
        vocab]``; the fused window's step on each row): each draft is
        accepted with the target probability of its token under the
        temperature/top-k/top-p distribution, the correction is sampled
        from the residual (or the bonus from the whole distribution), with
        the draws of each ``spec.seed`` at output count ``spec.n_out``
        (``ops/sampling.spec_draws``). ``d_static`` is the requests'
        ``num_draft_tokens``: the window runs at that width whatever the
        drafts found, as the fused window does. ``window_logits``: the
        window put's ``[S, N, vocab]`` (rows ``0..len(draft)`` of each
        valid); ``fed[i]`` the tokens row i fed after its input token
        (default its drafts; more where filler followed them), all rolled
        back past the accepted drafts, as in :meth:`accept_drafts`.
        Returns ``[(new_tokens, n_accepted)]`` in ``uids``' order."""
        d = max(1, int(d_static))
        n = len(uids)
        S = _bucket(n, floor=1)
        dev = self._model.device
        logits = torch.as_tensor(window_logits, device=dev)
        V = logits.shape[-1]
        wl = torch.zeros(S, 1 + d, V, dtype=torch.float32, device=dev)
        w = min(1 + d, logits.shape[1])
        wl[:min(S, logits.shape[0]), :w] = logits[:S, :w].float()
        host = np.zeros((4, S), np.int64)  # draft lengths, seeds, output counts, top-k
        table = np.zeros((S, d), np.int32)
        f32 = np.zeros((2, S), np.float32)  # temperatures, top-p
        f32[1] = 1.0
        for i, (draft, spec) in enumerate(zip(drafts, specs)):
            table[i, :len(draft)] = draft
            host[:, i] = (len(draft), spec.seed, spec.n_out, spec.top_k)
            f32[:, i] = (spec.temperature, spec.top_p)
        host_t = torch.from_numpy(host).to(dev)
        f32_t = torch.from_numpy(f32).to(dev)
        uniforms, gumbel = dsamp.spec_draws(host_t[1], host_t[2].int(), d, V)
        out, n_emit = dsamp.spec_verify_window(
            wl, torch.from_numpy(table).to(dev), host_t[0].int(), uniforms, gumbel, f32_t[0],
            host_t[3].int(), f32_t[1], d=d)
        got = torch.cat([n_emit[:, None], out], dim=1)[:n].cpu().numpy()
        results = []
        for i, uid in enumerate(uids):
            m = int(got[i, 0]) - 1
            self._settle_window(uid, len(drafts[i]) if fed is None else fed[i], m)
            results.append(([int(t) for t in got[i, 1:m + 2]], m))
        return results

    def fused_spec_decode_steps(self, batch_uids, histories, n_steps: int, *,
                                num_draft_tokens: int, draft_ngram: int, specs=None):
        """``n_steps`` speculative draft/verify windows with one host fetch
        (``model.fused_spec_decode``; on the card one captured step
        replayed ``n_steps`` times). ``histories[i]`` is uid i's prompt and
        outputs, whose last token is the next to feed; its trailing
        ``spec_ring_window`` tokens seed the device ring. The blocks of the
        worst case, ``n_steps * (1 + d)`` tokens, are reserved first (if
        they do not fit it raises ``SchedulingError`` with nothing
        allocated); a rejected tail is overwritten by the next window.
        ``specs=None`` verifies greedily (the per-token ``accept_drafts``
        stream); with one :class:`SampleSpec` per uid by rejection
        sampling, each window with the draws of its sequence's output count
        at its start and, as the per-token path drafts, at most ``max_new -
        n_out - 1`` and ``max_context - seen - 2`` drafts, so that both
        paths give one stream where the live windows fit one ragged batch.
        Returns ``(tokens, drafted, accepted)``: each uid's
        emitted tokens and its drafted and accepted totals."""
        return self.fused_spec_decode_harvest(self.fused_spec_decode_begin(
            batch_uids, histories, n_steps, num_draft_tokens=num_draft_tokens,
            draft_ngram=draft_ngram, specs=specs))

    def fused_spec_decode_begin(self, batch_uids, histories, n_steps: int, *,
                                num_draft_tokens: int, draft_ngram: int, specs=None):
        """The dispatch half of :meth:`fused_spec_decode_steps`: checks and
        reserves the worst case's blocks and enqueues the windows; the
        sequences' bookkeeping waits for the harvest."""
        batch_uids = list(batch_uids)
        d = max(1, int(num_draft_tokens))
        scfg = self._config.sampling
        max_ngram = int(scfg.spec_max_ngram)
        if draft_ngram > max_ngram:
            raise ValueError(f"draft_ngram {draft_ngram} exceeds spec_max_ngram {max_ngram}")
        W = self.spec_ring_window(d)
        seqs = []
        for uid in batch_uids:
            seq = self._state_manager.get_sequence(uid)
            if seq is None or seq.seen_tokens == 0:
                raise ValueError(f"fused_spec_decode_steps: uid {uid} is not a live "
                                 "prefilled sequence")
            seqs.append(seq)
        sm = self._config.state_manager
        if len(seqs) > sm.max_ragged_sequence_count:
            raise SchedulingError(SchedulingResult.BatchSequenceLimitExceeded)
        worst = n_steps * (1 + d)
        free = self._state_manager.free_blocks
        for seq in seqs:
            if seq.seen_tokens + worst > sm.max_context:
                raise SchedulingError(SchedulingResult.SequenceTokenLimitExceeded)
            n_fit, req = self._model.get_kv_requirements(seq, worst, free)
            if n_fit != worst:
                raise SchedulingError(SchedulingResult.KVCacheLimitExceeded)
            free -= req
        for seq in seqs:
            self._model.maybe_allocate_kv(seq, worst)
        B = _bucket(max(s.cur_allocated_blocks for s in seqs), floor=1)
        n = len(seqs)
        hist = np.zeros((n, W), np.int32)
        hist_len = np.zeros(n, np.int32)
        for i, h in enumerate(histories):
            L = len(h)
            tail = np.asarray(h[max(0, L - W):], np.int32)
            hist[i, np.arange(L - tail.size, L) % W] = tail  # position p in slot p % W
            hist_len[i] = L
        tokens = [int(h[-1]) for h in histories]
        sampling = None
        if specs is not None:
            big = 1 << 30
            sampling = {"temps": [s.temperature for s in specs],
                        "top_ks": [s.top_k for s in specs],
                        "top_ps": [s.top_p for s in specs],
                        "seeds": [s.seed for s in specs],
                        "n_out": [s.n_out for s in specs],
                        "max_new": [big if s.max_new is None else s.max_new for s in specs],
                        "max_context": sm.max_context}
        out, n_emit, dlen = self._model.fused_spec_decode(
            tokens, [s.seen_tokens for s in seqs], np.stack([s.block_table(B) for s in seqs]),
            hist, hist_len, [int(draft_ngram)] * n, [d] * n, n_steps, d, max_ngram,
            sampling=sampling)
        return _InFlightSpecWave(seqs=seqs, tokens=tokens, out=out, n_emit=n_emit, dlen=dlen)

    def fused_spec_decode_harvest(self, wave: _InFlightSpecWave):
        """The fetch half of :meth:`fused_spec_decode_steps`: one
        device-to-host copy, then each sequence's history advances by what
        it emitted (the blocks of the worst case stay with it) and, with
        prefix caching, its fed tokens are staged."""
        K, n, Np1 = wave.out.shape
        host = torch.cat([wave.out.reshape(K, n * Np1), wave.n_emit, wave.dlen],
                         dim=1).cpu().numpy()
        out = host[:, :n * Np1].reshape(K, n, Np1)
        n_emit, dlen = host[:, n * Np1:n * Np1 + n], host[:, n * Np1 + n:]
        pc = self._state_manager.prefix_cache
        toks_lists, drafted, accepted = [], [], []
        for i, seq in enumerate(wave.seqs):
            emitted = [int(t) for w in range(K) for t in out[w, i, :n_emit[w, i]]]
            seq.pre_forward(len(emitted))
            seq.post_forward()
            if pc is not None:
                self._append_pending(seq, [wave.tokens[i]] + emitted[:-1])
            toks_lists.append(emitted)
            drafted.append(int(dlen[:, i].sum()))
            accepted.append(len(emitted) - K)
        return toks_lists, drafted, accepted

    @staticmethod
    def normalize_stop(stop):
        """``stop`` → list of token-id sequences (one flat list = one
        sequence; None/empty = no stop sequences)."""
        if not stop:
            return []
        if all(isinstance(t, (int, np.integer)) for t in stop):
            stop = [stop]
        out = [[int(t) for t in s] for s in stop]
        if any(not s for s in out):
            raise ValueError("empty stop sequence")
        return out

    @staticmethod
    def hit_stop(outputs, stop_seqs) -> bool:
        return any(len(outputs) >= len(s) and outputs[-len(s):] == s
                   for s in stop_seqs)

    def generate(self, prompts, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 1.0,
                 return_logprobs: bool = False, seed: int = 0,
                 speculative: Optional[str] = None, num_draft_tokens: int = 4,
                 draft_ngram: int = 2, num_return_sequences: int = 1, stop=None,
                 min_new_tokens: int = 0, repetition_penalty: float = 1.0,
                 logits_processor=None, fused_decode_window: Optional[int] = None):
        """Continuous-batching decode: admit prompts in scheduler-feasible
        waves (Dynamic SplitFuse ``can_schedule`` gating), decode every live
        sequence in ONE ragged batch per step, free KV on completion.
        Returns the generated token list per prompt (no prompt echo).

        Admission reserves DECODE headroom, not just prompt KV: a sequence
        only enters when blocks for ``len(feed) + max_new_tokens`` fit after
        the projected growth of every live sequence. If the allocator still
        runs dry mid-generation, the newest live sequence is evicted and
        later replayed (prompt + tokens so far).

        Sampling controls (HF-generate parity): ``stop`` token-id
        sequence(s) end generation when the output tail matches (the
        matched tokens are included); ``min_new_tokens`` masks eos until
        reached; ``repetition_penalty`` is the CTRL rule over prompt +
        output history; ``logits_processor(history, row) -> row`` runs last,
        on the host. Requests without a processor sample on the device
        (``sampling.device_sampling``), plain greedy ones by a host argmax.

        ``fused_decode_window``: the cap on K, the steps of one fused window
        (``fused_decode_steps``); default 16 on a CUDA engine, 1 (off) on
        the CPU. Greedy requests and device-sampled ones (with
        ``sampling.fused_sampled_decode``) take it; eos and ``stop`` trim
        the window's tokens as the per-step path would have stopped.

        ``speculative="prompt_lookup"``: each step drafts up to
        ``num_draft_tokens`` tokens by matching the trailing
        ``draft_ngram`` tokens against the earlier history and verifies
        them in one forward with window logits, greedily (the stream is
        plain greedy's) or, with a temperature, by rejection sampling; or K
        windows at once in the fused speculative window (the fused window
        cap, ``sampling.fused_speculative_decode``). It refuses
        ``return_logprobs``, ``min_new_tokens``, ``repetition_penalty`` and
        ``logits_processor``; ``last_spec_stats`` holds the drafted and
        accepted counts.

        ``num_return_sequences=N``: N samples of each prompt, in the order
        ``[p0_s0, ..., p0_sN-1, p1_s0, ...]``; with prefix caching each
        distinct prompt is prefilled once first and every sample adopts
        it."""
        stop = self.normalize_stop(stop)
        if fused_decode_window is None:
            cap = 16 if self._model.device.type == "cuda" else 1
        else:
            cap = int(fused_decode_window)
        if speculative is not None:
            if speculative != "prompt_lookup":
                raise ValueError(f"unknown speculative mode {speculative!r}")
            if return_logprobs:
                # the rejection-sampled token's probability is not the one
                # it was emitted with
                raise ValueError("speculative decoding does not return logprobs")
            if min_new_tokens or repetition_penalty != 1.0 or logits_processor is not None:
                # logit edits that depend on the history cannot be applied
                # at every position of one window forward
                raise ValueError("speculative decoding does not compose with "
                                 "min_new_tokens/repetition_penalty/logits_processor")
        rng = np.random.default_rng(seed)
        scfg = self._config.sampling
        device_sampled = (scfg.device_sampling and logits_processor is None
                          and (temperature != 0.0 or return_logprobs
                               or repetition_penalty != 1.0 or min_new_tokens > 0))
        spec_sampled = speculative is not None and temperature != 0.0
        if spec_sampled and not device_sampled:
            raise ValueError("speculative sampling requires sampling.device_sampling")
        self.last_spec_stats = {"drafted": 0, "accepted": 0}
        spec_match_window = (self.spec_ring_window(num_draft_tokens)
                             if speculative is not None else 0)
        spec_match_cache = {}

        if num_return_sequences > 1:
            if self._state_manager.prefix_cache is not None:
                self._prefill_prompts_once(prompts)
            prompts = [p for p in prompts for _ in range(num_return_sequences)]
        prompts = [list(map(int, np.asarray(p).reshape(-1))) for p in prompts]
        uids = list(range(len(prompts)))
        outputs = {u: [] for u in uids}
        logprobs = {u: [] for u in uids}
        # tokens to prefill on (re)admission: prompt, or prompt + generated
        # so far after an eviction
        feed = {u: list(prompts[u]) for u in uids}
        waiting = list(uids)
        live: list = []
        last_tok = {}
        sm = self._config.state_manager
        max_batch_tokens = sm.max_ragged_batch_size
        # the decode batch feeds one token per live sequence, so live count
        # is bounded by BOTH sequence and token limits
        max_seqs = min(sm.max_ragged_sequence_count, max_batch_tokens)

        def _spec(u):
            return SampleSpec(
                temperature=temperature, top_k=top_k, top_p=top_p,
                repetition_penalty=repetition_penalty, eos_token_id=eos_token_id,
                block_eos=len(outputs[u]) < min_new_tokens,
                history=(prompts[u] + outputs[u]) if repetition_penalty != 1.0 else None,
                seed=dsamp.sequence_seed(seed, u), want_logprobs=return_logprobs,
                n_out=len(outputs[u]), min_new=min_new_tokens, max_new=max_new_tokens)

        def _controls(row, u):
            block_eos = len(outputs[u]) < min_new_tokens
            if repetition_penalty == 1.0 and not block_eos and logits_processor is None:
                return row  # controls off: skip the O(context) history copy
            return self.process_logits(
                row, prompts[u] + outputs[u], repetition_penalty=repetition_penalty,
                eos_token_id=eos_token_id, block_eos=block_eos,
                logits_processor=logits_processor)

        def _sample_wave(us, logits):
            """(token, logprob) for the first ``len(us)`` rows of the device
            ``logits``: one batched device call, or the numpy oracle."""
            if device_sampled:
                return list(zip(*self.sample_rows(us, logits, [_spec(u) for u in us])))
            rows = _host(logits[:len(us)])
            return [self._sample_with_logprob(
                _controls(rows[i], u), temperature, rng, top_k, top_p,
                want_lp=return_logprobs) for i, u in enumerate(us)]

        def _future_blocks(seq_desc, extra: int) -> int:
            _, req = self._model.get_kv_requirements(seq_desc, extra, 1 << 30)
            return req

        def _live_reserve() -> int:
            return sum(
                _future_blocks(self._state_manager.get_sequence(u),
                               max(0, max_new_tokens - len(outputs[u])))
                for u in live)

        def _prefill_chunked(u) -> None:
            """Solo SplitFuse prefill for a feed longer than one ragged
            batch; only the final chunk's logits matter."""
            for ofs in range(0, len(feed[u]), max_batch_tokens):
                logits = self.put([u], [feed[u][ofs:ofs + max_batch_tokens]],
                                  do_checks=False)
            (last_tok[u], lp), = _sample_wave([u], logits)
            outputs[u].append(last_tok[u])
            logprobs[u].append(lp)
            live.append(u)

        def _absorb_new_tokens(u, new_toks, new_lps=None):
            """The trim rule of a multi-token wave (a fused window or a
            verified speculative one): append, cut at the earliest eos,
            then at the earliest stop-sequence end inside the wave, cap at
            the output budget. A trimmed sequence retires, so the KV
            written past its cut needs no rollback."""
            outputs[u].extend(new_toks)
            logprobs[u].extend(new_lps if new_lps is not None else [0.0] * len(new_toks))
            if eos_token_id is not None and eos_token_id in new_toks:
                outputs[u] = outputs[u][:len(outputs[u]) - len(new_toks)
                                        + new_toks.index(eos_token_id) + 1]
            if stop:
                out = outputs[u]
                first = len(out) - len(new_toks) + 1
                for end in range(max(first, 1), len(out) + 1):
                    if self.hit_stop(out[:end], stop):
                        outputs[u] = out[:end]
                        break
            outputs[u] = outputs[u][:max_new_tokens]
            logprobs[u] = logprobs[u][:len(outputs[u])]
            last_tok[u] = outputs[u][-1]

        def _settle_wave(u) -> None:
            """A wave's deferred bookkeeping for a sequence that decodes
            on: its completed blocks join the prefix cache and its
            trailing-window blocks free (a retiring one just flushes)."""
            if not self.decode_finished(u, outputs[u], max_new_tokens, eos_token_id, stop):
                seq = self._state_manager.get_sequence(u)
                self._register_pending(seq)
                self._model.maybe_free_kv(seq)

        def _tick_solo(solo) -> None:
            """The sequences within a token of retiring tick alone."""
            for u in solo:
                try:
                    logits_u = self.put([u], [[last_tok[u]]])
                except SchedulingError:
                    continue  # replayed by the per-step path's eviction
                (last_tok[u], lp), = _sample_wave([u], logits_u)
                outputs[u].append(last_tok[u])
                logprobs[u].append(lp)

        def _sampled_windows(us, drafts):
            """One sampled verify window of each of ``us`` at the full width
            ``1 + num_draft_tokens`` (where the batch's token budget holds
            it): its drafts, then filler (its input token again) that the
            verify masks and the rollback drops; one put with window logits
            and one batched verify. None (nothing changed) when the blocks
            do not fit."""
            width, feeds = {}, []
            pad = len(us) * (1 + num_draft_tokens) <= max_batch_tokens
            for u in us:
                seq = self._state_manager.get_sequence(u)
                width[u] = max(len(drafts[u]), min(num_draft_tokens,
                                                   sm.max_context - seq.seen_tokens - 1)
                               if pad else 0)
                feeds.append([last_tok[u]] + drafts[u] + [last_tok[u]]
                             * (width[u] - len(drafts[u])))
            try:
                logits = self.put(us, feeds, window_logits=True, defer_register=set(us))
            except SchedulingError:
                return None
            results = self.verify_sampled_windows(us, [drafts[u] for u in us], logits,
                                                  [_spec(u) for u in us], num_draft_tokens,
                                                  fed=[width[u] for u in us])
            for u, (new_toks, m) in zip(us, results):
                self.last_spec_stats["drafted"] += len(drafts[u])
                self.last_spec_stats["accepted"] += m
                self._model.maybe_free_kv(self._state_manager.get_sequence(u))
                _absorb_new_tokens(u, new_toks)
            return results

        fused_plain = (speculative is None and temperature == 0.0 and not return_logprobs
                       and min_new_tokens == 0 and repetition_penalty == 1.0
                       and logits_processor is None)
        fused_ok = cap > 1 and (fused_plain or (device_sampled and speculative is None
                                                and scfg.fused_sampled_decode))
        fused_spec_ok = (speculative is not None and cap > 1 and scfg.fused_speculative_decode
                         and draft_ngram <= scfg.spec_max_ngram)

        while waiting or live:
            free = self._state_manager.free_blocks - _live_reserve()
            admit, admit_blocks = [], 0
            for u in list(waiting):
                if len(live) + len(admit) >= max_seqs:
                    break
                if len(feed[u]) > sm.max_context:
                    raise SchedulingError(SchedulingResult.SequenceTokenLimitExceeded)
                if _future_blocks(PlaceholderSequenceDescriptor(), len(feed[u])) \
                        > self._state_manager.kv_cache.num_blocks:
                    raise SchedulingError(SchedulingResult.KVCacheLimitExceeded)
                need = _future_blocks(
                    PlaceholderSequenceDescriptor(),
                    len(feed[u]) + max(0, max_new_tokens - len(outputs[u])))
                if len(feed[u]) > max_batch_tokens:
                    if admit or need > free:
                        break
                    waiting.remove(u)
                    _prefill_chunked(u)
                    break
                trial = admit + [u]
                if self.can_schedule(trial, [len(feed[t]) for t in trial]) \
                        != SchedulingResult.Success:
                    break
                if admit_blocks + need > free:
                    break
                admit.append(u)
                admit_blocks += need
                waiting.remove(u)
            if not admit and not live and waiting:
                # full decode headroom will never fit — admit ONE sequence
                # on prefill feasibility alone rather than deadlocking
                u = waiting[0]
                if len(feed[u]) > max_batch_tokens:
                    if _future_blocks(PlaceholderSequenceDescriptor(),
                                      len(feed[u])) \
                            > self._state_manager.free_blocks:
                        raise SchedulingError(SchedulingResult.KVCacheLimitExceeded)
                    waiting.remove(u)
                    _prefill_chunked(u)
                else:
                    check = self.can_schedule([u], [len(feed[u])])
                    if check != SchedulingResult.Success:
                        raise SchedulingError(check)
                    admit = [waiting.pop(0)]
            if admit:
                logits = self.put(admit, [feed[u] for u in admit], do_checks=False)
                picks = _sample_wave(admit, logits)
                for i, u in enumerate(admit):
                    last_tok[u], lp = picks[i]
                    outputs[u].append(last_tok[u])
                    logprobs[u].append(lp)
                    live.append(u)
            for u in list(live):
                if self.decode_finished(u, outputs[u], max_new_tokens,
                                        eos_token_id, stop):
                    live.remove(u)
                    self.flush(u)
            if not live:
                continue

            if fused_ok:
                # a mixed-progress wave splits: the sequences with >= 2
                # tokens of room ride a window at the largest K they all
                # take, the ones within a token of retiring tick alone
                fusable, K, solo = self.fused_partition(
                    live, [max_new_tokens - len(outputs[u]) for u in live], cap)
                toks = None
                if K >= 2:
                    try:
                        toks = self.fused_decode_steps(
                            fusable, [last_tok[u] for u in fusable], K,
                            specs=None if fused_plain else [_spec(u) for u in fusable])
                    except SchedulingError:
                        pass  # KV pressure: the per-step path below evicts
                if toks is not None:
                    toks, lps = (toks, None) if fused_plain else toks
                    for i, u in enumerate(fusable):
                        _absorb_new_tokens(u, [int(t) for t in toks[i]],
                                           None if lps is None else [float(x) for x in lps[i]])
                        _settle_wave(u)
                    _tick_solo(solo)
                    continue  # both groups retire at the top of the next iteration

            if fused_spec_ok:
                # drafting, verification and rejection sampling of K
                # windows in one fused window, one host fetch
                fusable, K, solo = self.fused_spec_partition(
                    live, [max_new_tokens - len(outputs[u]) for u in live],
                    num_draft_tokens, cap)
                res = None
                if K >= 2:
                    try:
                        res = self.fused_spec_decode_steps(
                            fusable, [prompts[u] + outputs[u] for u in fusable], K,
                            num_draft_tokens=num_draft_tokens, draft_ngram=draft_ngram,
                            specs=[_spec(u) for u in fusable] if spec_sampled else None)
                    except SchedulingError:
                        pass  # KV pressure: the per-token path below evicts
                if res is not None:
                    toks_lists, drafted_n, accepted_n = res
                    for i, u in enumerate(fusable):
                        self.last_spec_stats["drafted"] += drafted_n[i]
                        self.last_spec_stats["accepted"] += accepted_n[i]
                        _absorb_new_tokens(u, toks_lists[i])
                        _settle_wave(u)
                    if spec_sampled and solo:
                        # draft-free full-width windows, as the per-token
                        # path runs them (KV pressure: the eviction path)
                        _sampled_windows(solo, {u: [] for u in solo})
                    elif not spec_sampled:
                        _tick_solo(solo)
                    continue

            # the drafts of all live sequences share the batch's token
            # budget (each sequence feeds its one real token first); each
            # sequence's room is bounded by its context and output budgets
            draft_budget = max(0, max_batch_tokens - len(live)) if speculative else 0
            drafts = {}
            for u in live:
                if speculative:
                    seq = self._state_manager.get_sequence(u)
                    room = min(num_draft_tokens, draft_budget,
                               sm.max_context - seq.seen_tokens - 2,
                               max_new_tokens - len(outputs[u]) - 1)
                    drafts[u] = self.prompt_lookup_draft(
                        prompts[u] + outputs[u], draft_ngram=draft_ngram, max_tokens=room,
                        match_window=spec_match_window,
                        match_cache=spec_match_cache.setdefault(u, {}))
                else:
                    drafts[u] = []
                draft_budget -= len(drafts[u])
            if spec_sampled:
                # every sampled window runs at the full width, as the fused
                # window does (so that both batch the same shapes and give
                # the same logits); the KV pressure path evicts
                while live and _sampled_windows(live, drafts) is None:
                    u = live.pop()  # newest first: oldest finish soonest
                    self.flush(u)
                    if live:
                        feed[u] = prompts[u] + outputs[u]
                        waiting.insert(0, u)
                continue
            use_window = any(drafts[u] for u in live)
            # per-step decode: one token (and its drafts) per live sequence
            # in one forward
            while live:
                try:
                    logits = self.put(
                        live, [[last_tok[u]] + drafts[u] for u in live],
                        window_logits=use_window,
                        defer_register=({u for u in live if drafts[u]} if use_window
                                        else frozenset()))
                    break
                except SchedulingError:
                    if use_window:
                        # drafts do not justify evicting a sequence: retry
                        # the step without them first
                        drafts = {u: [] for u in live}
                        use_window = False
                        continue
                    u = live.pop()  # newest first: oldest finish soonest
                    self.flush(u)
                    if live:
                        feed[u] = prompts[u] + outputs[u]
                        waiting.insert(0, u)  # replay once blocks free up
                    # else: lone sequence exhausted the whole cache — its
                    # generation is truncated at the tokens produced so far
            if not live:
                continue
            if use_window:
                # greedy verify by argmax match (one fetch of the window's
                # argmax): the accepted drafts and the correction or bonus
                # token, the rejected tail rolled back
                top = logits[:len(live)].argmax(-1).cpu()
                for i, u in enumerate(live):
                    new_toks, m = self.accept_drafts(u, drafts[u], top[i])
                    self.last_spec_stats["drafted"] += len(drafts[u])
                    self.last_spec_stats["accepted"] += m
                    # the window put deferred the trailing-window free
                    self._model.maybe_free_kv(self._state_manager.get_sequence(u))
                    _absorb_new_tokens(u, new_toks)
            else:
                picks = _sample_wave(live, logits)
                for i, u in enumerate(live):
                    last_tok[u], lp = picks[i]
                    outputs[u].append(last_tok[u])
                    logprobs[u].append(lp)
        if return_logprobs:
            return [outputs[u] for u in uids], [logprobs[u] for u in uids]
        return [outputs[u] for u in uids]

    def _prefill_prompts_once(self, prompts) -> None:
        """Prefill each distinct prompt longer than a block once on a
        scratch sequence and flush it, so that its blocks stay in the
        prefix cache for the samples to adopt (the JAX ``:1414-1430``)."""
        scratch = 1 << 27
        seen = set()
        for p in prompts:
            arr = np.asarray(p, np.int32).reshape(-1)
            key = arr.tobytes()
            if key in seen or arr.size <= self._state_manager.block_size:
                continue
            seen.add(key)
            try:
                self.put([scratch], [arr], do_checks=False)
            except SchedulingError:
                break  # the cache is full: the samples compute their own
            self.flush(scratch)
            scratch += 1

    def flush(self, uid: int) -> None:
        self._state_manager.flush_sequence(uid)


def build_llama_engine(config: Optional[LlamaConfig] = None,
                       params=None,
                       engine_config: Optional[RaggedInferenceEngineConfig] = None,
                       seed: int = 0,
                       dtype=None,
                       kv_block_size: int = 64,
                       quantize: Optional[str] = None,
                       kv_cache_dtype: Optional[str] = None,
                       device=None) -> InferenceEngineV2:
    """Factory (reference ``engine_factory.py build_hf_engine``): build a
    ragged engine from a Llama config and weights — a :class:`LlamaModel`,
    a JAX param tree with numpy leaves (loaded through
    ``models/convert.params_from_jax``), or seeded random weights if None.
    ``quantize="int8"`` (or ``engine_config.quantization.quantization_mode
    = "int8"``) holds the layer kernels as int8; ``kv_cache_dtype="int8"``
    the KV cache. Runs on ``cuda`` unless ``device`` says otherwise."""
    device = resolve_device(device)
    config = config or LlamaConfig.tiny()
    engine_config = engine_config or RaggedInferenceEngineConfig()
    mode = engine_config.quantization.quantization_mode
    if mode:
        # the reference spells weight-only quantization as a mode
        # ('wf6af16' = weight fp6, activations fp16); it maps onto quantize
        mapped = {"wf6af16": "fp6", "fp6": "fp6",
                  "int8": "int8", "int4": "int4"}.get(mode)
        if mapped is None:
            raise ValueError(f"unknown quantization_mode {mode!r}; "
                             "supported: wf6af16 (fp6), fp6, int8, int4")
        if quantize is not None and quantize != mapped:
            raise ValueError(
                f"quantize={quantize!r} conflicts with "
                f"quantization_mode={mode!r} (= {mapped!r}) — set one")
        quantize = mapped
    dtype = dtype or torch.bfloat16
    if params is None:
        model = init_llama(config, seed=seed, dtype=dtype, device=device)
    elif isinstance(params, LlamaModel):
        model = params
    else:
        from ...models.convert import params_from_jax
        model = params_from_jax(params, config, dtype=dtype, device=device)
    ragged = RaggedLlamaModel(config, model, dtype=dtype,
                              kv_block_size=kv_block_size, quantize=quantize,
                              kv_cache_dtype=kv_cache_dtype)
    return InferenceEngineV2(ragged, engine_config)
