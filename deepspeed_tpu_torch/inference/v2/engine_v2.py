"""InferenceEngineV2 — ragged continuous-batching serving engine (port of
``deepspeed_tpu/inference/v2/engine_v2.py``; reference
``deepspeed/inference/v2/engine_v2.py:30``).

Same contract: ``put(uids, tokens)`` runs one ragged forward returning one
logits row per sequence; ``query``/``can_schedule`` expose the Dynamic
SplitFuse feasibility math; ``flush`` drops a sequence's KV; ``generate``
is the continuous-batching decode loop with admission under decode
headroom, chunked prefill and evict-and-replay. Decoding runs one ragged
forward per step; sampling is host numpy. Not ported yet: prefix
adoption, fused multi-step and speculative decode, device sampling,
logit controls (min_new_tokens, repetition penalty, processors),
parallel sampling, multi-LoRA, fault injection and metrics.
"""

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ...models.llama import LlamaConfig, LlamaModel, init_llama
from ...utils.device import resolve_device
from .config_v2 import RaggedInferenceEngineConfig
from .model import RaggedLlamaModel
from .ragged.ragged_manager import DSStateManager
from .ragged.ragged_wrapper import RaggedBatchWrapper
from .ragged.sequence_descriptor import PlaceholderSequenceDescriptor
from .scheduling_utils import SchedulingError, SchedulingResult


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


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
                 return_logprobs: bool = False, seed: int = 0, stop=None):
        """Continuous-batching decode: admit prompts in scheduler-feasible
        waves (Dynamic SplitFuse ``can_schedule`` gating), decode every live
        sequence in ONE ragged batch per step, free KV on completion.
        Returns the generated token list per prompt (no prompt echo).

        Admission reserves DECODE headroom, not just prompt KV: a sequence
        only enters when blocks for ``len(feed) + max_new_tokens`` fit after
        the projected growth of every live sequence. If the allocator still
        runs dry mid-generation, the newest live sequence is evicted and
        later replayed (prompt + tokens so far)."""
        stop = self.normalize_stop(stop)
        rng = np.random.default_rng(seed)

        def _sample_wave(us, rows):
            return [self._sample_with_logprob(
                rows[i], temperature, rng, top_k, top_p,
                want_lp=return_logprobs) for i in range(len(us))]

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
            (last_tok[u], lp), = _sample_wave([u], [_host(logits[0])])
            outputs[u].append(last_tok[u])
            logprobs[u].append(lp)
            live.append(u)

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
                logits = _host(self.put(admit, [feed[u] for u in admit],
                                        do_checks=False))
                picks = _sample_wave(admit, [logits[i]
                                             for i in range(len(admit))])
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

            # per-step decode: one token per live sequence in one forward
            while live:
                try:
                    logits = _host(self.put(live, [[last_tok[u]] for u in live]))
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
            picks = _sample_wave(live, [logits[i] for i in range(len(live))])
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
