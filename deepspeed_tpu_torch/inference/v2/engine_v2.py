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
``logits_processor`` requests. Not ported yet: prefix adoption,
speculative decode, parallel sampling, multi-LoRA, fault injection and
metrics.
"""

import dataclasses
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


@dataclasses.dataclass
class _InFlightWave:
    """A fused window enqueued on the device and not fetched yet: ``out``
    and ``lps`` are device tensors until ``fused_decode_harvest``. The
    sequences' host bookkeeping advanced at dispatch."""
    out: torch.Tensor            # [n_steps, n] int32
    lps: Optional[torch.Tensor]  # [n_steps, n] fp32 (sampled windows)


class InferenceEngineV2:

    def __init__(self, model: RaggedLlamaModel, engine_config: RaggedInferenceEngineConfig):
        self._config = engine_config
        self._model = model
        kv_config = model.kv_cache_config()
        self._batch = RaggedBatchWrapper(engine_config.state_manager,
                                         block_size=kv_config.block_size,
                                         device=model.device)
        self._state_manager = DSStateManager(engine_config.state_manager, kv_config,
                                             num_blocks=engine_config.num_kv_blocks,
                                             device=model.device)
        self._model.set_state_manager(self._state_manager)

    # ---- properties (reference engine_v2.py:47-66) ----

    @property
    def free_blocks(self) -> int:
        return self._state_manager.free_blocks

    def model(self) -> RaggedLlamaModel:
        return self._model

    # ---- serving (reference :107 put) ----

    def put(self, batch_uids: Iterable[int], batch_tokens: Iterable,
            do_checks: bool = True) -> torch.Tensor:
        """One ragged forward; returns fp32 logits [n_seqs_padded, vocab]
        on the model's device — row i is the next-token distribution for
        batch_uids[i]."""
        batch_uids = list(batch_uids)
        batch_tokens = [np.asarray(t, dtype=np.int32).reshape(-1) for t in batch_tokens]

        if do_checks:
            token_lens = [t.size for t in batch_tokens]
            schedule_check = self.can_schedule(batch_uids, token_lens)
            if schedule_check != SchedulingResult.Success:
                raise SchedulingError(schedule_check)

        self._batch.clear()
        for uid, tokens in zip(batch_uids, batch_tokens):
            host_seq_desc = self._state_manager.get_or_create_sequence(uid)
            self._model.maybe_allocate_kv(host_seq_desc, tokens.size)
            host_seq_desc.pre_forward(tokens.size)
            self._batch.insert_sequence(host_seq_desc, tokens, do_checks=do_checks)

        batch = self._batch.finalize(
            total_slots=self._state_manager.kv_cache.num_blocks *
            self._state_manager.kv_cache.block_size)
        logits = self._model.forward(batch)

        for uid in batch_uids:
            seq = self._state_manager.get_sequence(uid)
            seq.post_forward()
            self._model.maybe_free_kv(seq)
        return logits

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
        out, lps = self._model.fused_decode([int(t) for t in last_tokens], lens, table,
                                            n_steps, widths=widths, sampling=sampling)
        for seq in seqs:
            seq.pre_forward(n_steps)
            seq.post_forward()
        return _InFlightWave(out=out, lps=lps)

    def fused_decode_harvest(self, wave: _InFlightWave):
        """The fetch half of :meth:`fused_decode_steps`: one device-to-host
        copy of the window's tokens (and logprobs, by their bits) and the
        per-sequence contract, ``[n_seqs, n_steps]``."""
        if wave.lps is None:
            return wave.out.cpu().numpy().T
        both = torch.stack([wave.out, wave.lps.view(torch.int32)]).cpu().numpy()
        return both[0].T, both[1].view(np.float32).T

    def warmup(self, prefill_lens=(128, ), batch_sizes=(1, ), fused_windows=(),
               fused_sampled_windows=(), decode_context: int = 0) -> int:
        """Run the paths serving will hit before the first request, so that
        no request pays for a first launch or a graph capture: a prefill at
        each length, the per-step decode at each batch size, and the fused
        window's step graphs at each K of ``fused_windows`` (greedy) and
        ``fused_sampled_windows`` (sampled, logprobs on) per batch size, on
        scratch sequences of ``decode_context`` tokens (the graphs' key
        holds the block-table width), which are flushed after. Returns the
        number of step graphs captured."""
        base = 1 << 28  # scratch uids clear of real ones
        for n in prefill_lens:
            self.put([base], [np.zeros(int(n), np.int32)], do_checks=False)
            self.put([base], [[0]])
            self.flush(base)
        for bs in batch_sizes:
            uids = list(range(base + 1, base + 1 + bs))
            for u in uids:
                self.put([u], [np.zeros(max(1, int(decode_context)), np.int32)],
                         do_checks=False)
            self.put(uids, [[0]] * bs)
            for K in fused_windows:
                self.fused_decode_steps(uids, [0] * bs, int(K))
            for K in fused_sampled_windows:
                self.fused_decode_steps(uids, [0] * bs, int(K),
                                        specs=[SampleSpec(temperature=1.0, want_logprobs=True)
                                               for _ in uids])
            for u in uids:
                self.flush(u)
        return len(self._model._graphs)

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
                 return_logprobs: bool = False, seed: int = 0, stop=None,
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
        the window's tokens as the per-step path would have stopped."""
        stop = self.normalize_stop(stop)
        if fused_decode_window is None:
            cap = 16 if self._model.device.type == "cuda" else 1
        else:
            cap = int(fused_decode_window)
        rng = np.random.default_rng(seed)
        scfg = self._config.sampling
        device_sampled = (scfg.device_sampling and logits_processor is None
                          and (temperature != 0.0 or return_logprobs
                               or repetition_penalty != 1.0 or min_new_tokens > 0))

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
                n_out=len(outputs[u]), min_new=min_new_tokens)

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

        def _absorb_new_tokens(u, new_toks, new_lps):
            """The trim rule of a window's tokens: append, cut at the
            earliest eos, then at the earliest stop-sequence end inside the
            window, cap at the output budget. A trimmed sequence retires,
            so the KV written past its cut needs no rollback."""
            outputs[u].extend(new_toks)
            logprobs[u].extend(new_lps)
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

        fused_plain = (temperature == 0.0 and not return_logprobs and min_new_tokens == 0
                       and repetition_penalty == 1.0 and logits_processor is None)
        fused_ok = cap > 1 and (fused_plain or (device_sampled and scfg.fused_sampled_decode))

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
                                           [0.0] * K if lps is None
                                           else [float(x) for x in lps[i]])
                        if not self.decode_finished(u, outputs[u], max_new_tokens,
                                                    eos_token_id, stop):
                            self._model.maybe_free_kv(self._state_manager.get_sequence(u))
                    for u in solo:
                        try:
                            logits_u = self.put([u], [[last_tok[u]]])
                        except SchedulingError:
                            continue  # replayed by the per-step path's eviction
                        (last_tok[u], lp), = _sample_wave([u], logits_u)
                        outputs[u].append(last_tok[u])
                        logprobs[u].append(lp)
                    # both groups retire at the top of the next iteration
                    continue

            # per-step decode: one token per live sequence in one forward
            while live:
                try:
                    logits = self.put(live, [[last_tok[u]] for u in live])
                    break
                except SchedulingError:
                    u = live.pop()  # newest first: oldest finish soonest
                    self.flush(u)
                    if live:
                        feed[u] = prompts[u] + outputs[u]
                        waiting.insert(0, u)  # replay once blocks free up
                    # else: lone sequence exhausted the whole cache — its
                    # generation is truncated at the tokens produced so far
            if not live:
                continue
            picks = _sample_wave(live, logits)
            for i, u in enumerate(live):
                last_tok[u], lp = picks[i]
                outputs[u].append(last_tok[u])
                logprobs[u].append(lp)
        if return_logprobs:
            return [outputs[u] for u in uids], [logprobs[u] for u in uids]
        return [outputs[u] for u in uids]

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
