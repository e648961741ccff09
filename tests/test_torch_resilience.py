"""deepspeed_tpu_torch's resilience layer (``runtime/sentry.py``,
``utils/retry.py``, ``utils/fault_injection.py`` and the engine's
preemption autosave, auto-resume and rollback) against the JAX package's.

The sentry, the backoff and the fault plan are fed the same inputs as the
JAX modules and give the same outputs. The engine cases are JAX's
``tests/unit/runtime/test_engine_resilience.py`` in sync mode (the async
window is not ported) on a float-input model that mirrors the JAX
``SimpleModel`` weight for weight, driven by the port's fault injector: a
SIGTERM mid-run saves a committed checkpoint that a new engine resumes
from; interval autosaves keep the last ``keep_last_n``; a NaN episode rolls
back to the last good checkpoint while the data sampler keeps its
position. Through an autosave and a resume the port's losses on that
model are an uninterrupted run's, bit for bit, and the JAX engine's within
rtol 1e-4: the two engines' fp32 products sum in another order, and Adam
at lr 1e-2 moves a weight by up to 1e-2 a step, so by the fourth step the
small MSE differs by 1.3e-5 relative (the run that set this limit).
"""

import os
import random
import signal

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from deepspeed_tpu_torch.checkpoint.engine import (COMMIT_MARKER_FILE, read_latest_tag,
                                                   verify_checkpoint)
from deepspeed_tpu_torch.models.convert import lookup
from deepspeed_tpu_torch.runtime.sentry import AnomalySentry
from deepspeed_tpu_torch.utils import retry as tr
from deepspeed_tpu_torch.utils.fault_injection import FaultInjector, get_fault_injector

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _reset_port_faults():
    yield
    get_fault_injector().reset()


class SimpleModel(torch.nn.Module):
    """The JAX ``SimpleModel`` (``tests/unit/simple_model.py``)."""

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


def _params(seed=0):
    import sys
    import jax
    sys.path.insert(0, os.path.join(HERE, "unit"))
    from simple_model import simple_model_and_params
    return jax.tree_util.tree_map(np.asarray, simple_model_and_params(seed=seed)[1])


def _config(resilience):
    cfg = {"train_batch_size": 8, "optimizer": {"type": "Adam", "params": {"lr": 1e-2}}}
    if resilience is not None:
        cfg["resilience"] = resilience
    return cfg


def _engine(resilience=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm import reset_mesh_context
    reset_mesh_context()
    model = SimpleModel()
    tree = _params()
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(np.array(lookup(tree, name))))
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=_config(resilience),
                                             device="cpu")
    return eng


def _step(engine, x=None):
    x = torch.ones(8, 16) if x is None else x
    loss = engine.forward(x, torch.zeros_like(x))
    engine.backward(loss)
    engine.step()
    return loss


X = torch.linspace(0.0, 1.0, 8 * 16).reshape(8, 16)


# ---------------------------------------------------------------- the sentry


def test_sentry_detects_each_anomaly_kind():
    s = AnomalySentry(max_consecutive=2, spike_window=10, spike_factor=3.0,
                      spike_min_history=3)
    for i in range(4):
        assert s.observe(1.0 + 0.01 * i, False, i) is None
    assert s.observe(1.0, True, 4) == "overflow"
    assert s.observe(float("nan"), False, 5) == "nonfinite_loss"
    assert s.should_rollback
    s.reset()
    for i in range(4):
        s.observe(1.0, False, i)
    assert s.observe(10.0, False, 4) == "loss_spike"
    assert not s.should_rollback
    assert s.observe(1.0, False, 5) is None
    assert s.consecutive == 0


def test_sentry_needs_history_before_spike_detection():
    s = AnomalySentry(max_consecutive=3, spike_window=10, spike_factor=3.0,
                      spike_min_history=5)
    for i, loss in enumerate((9.0, 1.0, 8.0, 0.5)):
        assert s.observe(loss, False, i) is None


@settings(max_examples=40, deadline=None)
@given(st.data())
def test_sentry_matches_jax_on_a_loss_sequence(data):
    """The same sequence of losses (spikes, NaNs, infinities, overflow
    flags) through both sentries: the same verdict at every step, the same
    rollback points and counters."""
    from deepspeed_tpu.runtime.sentry import AnomalySentry as JaxSentry
    kw = dict(max_consecutive=data.draw(st.integers(1, 4)),
              spike_window=data.draw(st.integers(2, 8)),
              spike_factor=data.draw(st.floats(1.5, 5.0)),
              spike_min_history=data.draw(st.integers(1, 5)))
    seq = data.draw(st.lists(st.tuples(
        st.one_of(st.floats(-5, 50), st.sampled_from([float("nan"), float("inf")]), st.none()),
        st.booleans()), min_size=1, max_size=40))
    ours, ref = AnomalySentry(**kw), JaxSentry(**kw)
    for i, (loss, overflow) in enumerate(seq):
        assert ours.observe(loss, overflow, i) == ref.observe(loss, overflow, i)
        assert ours.should_rollback == ref.should_rollback
        if ours.should_rollback:
            ours.note_rollback("t", i)
            ref.note_rollback("t", i)
        assert (ours.consecutive, ours.total_anomalies, ours.rollbacks) == \
            (ref.consecutive, ref.total_anomalies, ref.rollbacks)


# ---------------------------------------------------------------- retry and the fault plan


@pytest.mark.parametrize("jitter", ["none", "full"])
def test_backoff_delays_match_jax(jitter):
    from deepspeed_tpu.utils import retry as jr
    a, b = random.Random(3), random.Random(3)
    for attempt in range(8):
        assert tr.backoff_delay(attempt, 0.05, 1.0, jitter, a) == \
            jr.backoff_delay(attempt, 0.05, 1.0, jitter, b)
    with pytest.raises(ValueError, match="jitter"):
        tr.backoff_delay(0, jitter="half")


def test_retry_with_backoff_retries_then_gives_up():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert tr.retry_with_backoff(flaky, retries=3, sleep=slept.append) == "ok"
    assert slept == [0.05, 0.1]
    with pytest.raises(tr.RetriesExhausted) as info:
        tr.retry_with_backoff(lambda: (_ for _ in ()).throw(OSError("down")), retries=2,
                              sleep=slept.append)
    assert isinstance(info.value.__cause__, OSError)
    with pytest.raises(KeyError):  # not a retried exception: no retry
        tr.retry_with_backoff(lambda: {}["x"], sleep=slept.append)


def test_fault_plan_fires_as_jax_does():
    """``DS_FAULT_INJECT`` syntax and occurrence counting: the same visits
    fire in both injectors."""
    from deepspeed_tpu.utils.fault_injection import FaultInjector as JaxInjector
    text = "checkpoint.torn_write@2;train.nan_grads@3*2"
    ours, ref = FaultInjector(), JaxInjector()
    ours.configure_env(text)
    ref.configure_env(text)
    for _ in range(6):
        for site in ("checkpoint.torn_write", "train.nan_grads", "train.sigterm"):
            assert (ours.fire(site) is None) == (ref.fire(site) is None)
    assert ours.fired == ref.fired
    with pytest.raises(ValueError, match="unknown fault site"):
        ours.configure({"faults": [{"site": "nowhere"}]})


def test_tear_and_corrupt_damage_the_largest_entry(tmp_path):
    from deepspeed_tpu_torch.utils.fault_injection import corrupt_file_in, tear_checkpoint_dir
    (tmp_path / "big").write_bytes(bytes(range(256)) * 4)
    (tmp_path / "small").write_bytes(b"ab")
    before = (tmp_path / "big").read_bytes()
    assert corrupt_file_in(str(tmp_path), seed=1).endswith("big")
    after = (tmp_path / "big").read_bytes()
    assert len(after) == len(before) and after != before
    assert tear_checkpoint_dir(str(tmp_path), truncate_to=16).endswith("big")
    assert os.path.getsize(tmp_path / "big") == 16


# ---------------------------------------------------------------- the engine


def test_losses_match_jax_through_an_autosave_and_resume(tmp_path):
    """Four steps of the port's engine with an autosave every two, and a
    new engine resumed from it: an uninterrupted run's losses, and the
    JAX engine's four."""
    import jax.numpy as jnp
    import deepspeed_tpu
    import sys
    sys.path.insert(0, os.path.join(HERE, "unit"))
    from simple_model import simple_model_and_params
    from deepspeed_tpu.comm.mesh import reset_mesh_context
    reset_mesh_context()
    model, params = simple_model_and_params(seed=0)
    j, *_ = deepspeed_tpu.initialize(model=model, model_parameters=params,
                                     config=_config(None))
    ref = []
    for k in range(4):
        x = jnp.asarray(X.numpy() * (k + 1))
        loss = j.forward(x, jnp.zeros_like(x))
        j.backward(loss)
        j.step()
        ref.append(float(loss))
    rc = {"enabled": True, "save_dir": str(tmp_path), "autosave_interval_steps": 2}
    e = _engine(rc)
    got = [_step(e, X * (k + 1)).item() for k in range(2)]
    e.destroy()
    e2 = _engine(dict(rc, auto_resume=True))
    assert e2.global_steps == 2
    got += [_step(e2, X * (k + 1)).item() for k in range(2, 4)]
    e2.destroy()
    e3 = _engine(None)
    assert got == [_step(e3, X * (k + 1)).item() for k in range(4)]  # the resume is exact
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_sigterm_autosave_and_auto_resume(tmp_path):
    save_dir = str(tmp_path)
    rc = {"enabled": True, "save_dir": save_dir,
          "fault_injection": {"enabled": True,
                              "faults": [{"site": "train.sigterm", "nth": 2}]}}
    e = _engine(rc)
    try:
        _step(e)
        _step(e)  # boundary 2: the injected SIGTERM -> flag -> autosave
        assert e.preempted
        tag = read_latest_tag(save_dir)
        assert tag == "global_step2"
        ckpt = os.path.join(save_dir, tag)
        assert os.path.exists(os.path.join(ckpt, COMMIT_MARKER_FILE))
        assert verify_checkpoint(ckpt) == (True, "ok")
    finally:
        e.destroy()
    e2 = _engine({"enabled": True, "save_dir": save_dir, "auto_resume": True})
    try:
        assert e2.global_steps == 2
        loss = _step(e2)
        assert e2.global_steps == 3 and np.isfinite(loss.item())
    finally:
        e2.destroy()


def test_sigterm_handler_restored_on_destroy(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    e = _engine({"enabled": True, "save_dir": str(tmp_path)})
    assert signal.getsignal(signal.SIGTERM) != prev
    e.destroy()
    assert signal.getsignal(signal.SIGTERM) == prev


def test_autosave_interval_and_retention(tmp_path):
    e = _engine({"enabled": True, "save_dir": str(tmp_path),
                 "autosave_interval_steps": 2, "keep_last_n": 2})
    for _ in range(6):
        _step(e)
    e.destroy()
    assert read_latest_tag(str(tmp_path)) == "global_step6"
    present = sorted(d for d in os.listdir(tmp_path) if d.startswith("global_step"))
    assert present == ["global_step4", "global_step6"]


def _nan_rc(tmp_path, nth=3, autosave=2):
    rc = {"enabled": True, "save_dir": str(tmp_path), "max_consecutive_anomalies": 2,
          "fault_injection": {"enabled": True,
                              "faults": [{"site": "train.nan_grads", "nth": nth, "times": 2}]}}
    if autosave:
        rc["autosave_interval_steps"] = autosave
    return rc


def test_nan_episode_triggers_rollback(tmp_path):
    e = _engine(_nan_rc(tmp_path))
    _step(e, X)
    _step(e, X)  # autosave: global_step2 is the last good checkpoint
    assert read_latest_tag(str(tmp_path)) == "global_step2"
    _step(e, X)
    _step(e, X)  # the second anomaly in a row: rollback
    assert e._sentry.rollbacks == 1 and e.global_steps == 2
    loss = _step(e, X)
    assert np.isfinite(loss.item())
    assert all(torch.isfinite(v).all() for v in e.full_master_params().values())
    e.destroy()


class _Sampler:
    """A data sampler's checkpointed position (``data_sampler.py``)."""

    def __init__(self):
        self.consumed_samples = 0

    def state_dict(self):
        return {"consumed_samples": self.consumed_samples}

    def load_state_dict(self, sd):
        self.consumed_samples = sd["consumed_samples"]


def test_rollback_keeps_sampler_position(tmp_path):
    e = _engine(_nan_rc(tmp_path))
    sampler = _Sampler()

    class _Loader:
        pass

    e.training_dataloader = _Loader()
    e.training_dataloader.sampler = sampler
    for _ in range(2):
        sampler.consumed_samples += 8
        _step(e, X)
    assert sampler.consumed_samples == 16  # captured in global_step2
    for _ in range(2):  # the poisoned window
        sampler.consumed_samples += 8
        _step(e, X)
    assert e._sentry.rollbacks == 1 and e.global_steps == 2
    assert sampler.consumed_samples == 32  # the data position kept
    e.destroy()


def test_rollback_without_checkpoint_does_not_crash(tmp_path):
    e = _engine(_nan_rc(tmp_path, nth=1, autosave=0))
    _step(e)
    _step(e)  # the threshold, and nothing to roll back to
    assert e._sentry.rollbacks == 0 and e.global_steps == 2
    _step(e)
    e.destroy()


def test_resilience_config_matches_jax_defaults():
    from deepspeed_tpu.config.feature_configs import ResilienceConfig as JaxRC
    from deepspeed_tpu_torch.config.config import DeepSpeedConfigError, DeepSpeedTorchConfig
    ours = DeepSpeedTorchConfig({"train_batch_size": 2}).resilience_config
    ref = JaxRC()
    for key in ("enabled", "save_dir", "autosave_interval_steps", "keep_last_n",
                "auto_resume", "preempt_save", "preempt_signals", "max_consecutive_anomalies",
                "loss_spike_window", "loss_spike_factor", "loss_spike_min_history", "rollback"):
        assert getattr(ours, key) == getattr(ref, key), key
    with pytest.raises(DeepSpeedConfigError):
        DeepSpeedTorchConfig({"train_batch_size": 2, "resilience": {"loss_spike_factor": 1.0}})
    with pytest.raises(NotImplementedError, match="resilience"):
        DeepSpeedTorchConfig({"train_batch_size": 2, "resilience": {"window": 3}})
