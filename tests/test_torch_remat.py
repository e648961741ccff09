"""Remat, its policies and the key-padding mask in the port's training
forward, against the JAX model and within the port, on the same seeded
weights and inputs, on the CPU: every ported ``remat_policy`` gives the
loss and gradients of no remat bit for bit and recomputes what it names;
``dots_saveable`` against the JAX model's (loss 1e-5 relative, grads 1e-5
absolute, as ``tests/unit/models/test_llama.py``); the engine-level
``activation_checkpointing.remat_policy``; ``attn_mask`` against the JAX
model's dense branch, left padding included."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import LlamaConfig as JaxLlamaConfig
from deepspeed_tpu.models import init_llama as jax_init_llama
from deepspeed_tpu_torch.models.convert import lookup, params_from_jax
from deepspeed_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing

POLICIES = ["nothing_saveable", "everything_saveable", "dots_saveable", "checkpoint_dots",
            "dots_with_no_batch_dims_saveable", "checkpoint_dots_with_no_batch_dims"]
LOSS_RTOL = 1e-5
GRAD_ATOL = 1e-5


def _pair(seed=0, **over):
    """The JAX model and its fp32 params, and the port's model on the same
    values (fp32)."""
    jcfg = JaxLlamaConfig.tiny(dtype=jnp.float32, attn_impl="flash",
                               num_key_value_heads=2, **over)
    jmodel, params = jax_init_llama(jcfg, seed=seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    tcfg = LlamaConfig.tiny(dtype=torch.float32, num_key_value_heads=2, **over)
    tmodel = params_from_jax(params, tcfg, dtype=torch.float32, device="cpu", training=True)
    return jmodel, params, tmodel


def _ids(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.int32)


def _port_loss_and_grads(model, ids, **kw):
    t = torch.from_numpy(ids).long()
    kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    loss = model(t, labels=t, **kw)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


class _CountForwardOps(TorchDispatchMode):
    """Counts the forward products (``mm``) and the RMSNorm ``rsqrt``s
    that run inside the backward, i.e. the recompute."""

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "rsqrt": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.counts:
            self.counts[name] += 1
        return func(*args, **(kwargs or {}))


def _recomputed(model, ids):
    """(mm, rsqrt) calls during ``backward`` less those without remat."""
    t = torch.from_numpy(ids).long()
    loss = model(t, labels=t)
    mode = _CountForwardOps()
    with mode:
        loss.backward()
    model.zero_grad(set_to_none=True)
    return mode.counts


@pytest.mark.parametrize("policy", POLICIES + [None])
def test_remat_policies_match_no_remat_and_recompute_what_they_name(policy):
    """``remat=True`` under each policy (None: recompute everything) gives
    no remat's loss and gradients bit for bit. In the backward, the
    products run again under the policies that keep no dots, the norms
    run again under every policy but ``everything_saveable``, which
    recomputes nothing."""
    _, _, base = _pair()
    ids = _ids(1, (2, 24))
    ref_loss, ref_grads = _port_loss_and_grads(base, ids)
    ref_counts = _recomputed(base, ids)
    model = LlamaForCausalLM(dataclasses.replace(base.config, remat=True, remat_policy=policy),
                             device="cpu")
    model.load_state_dict(base.state_dict())
    loss, grads = _port_loss_and_grads(model, ids)
    assert torch.equal(loss, ref_loss)
    assert all(torch.equal(grads[n], g) for n, g in ref_grads.items())
    counts = _recomputed(model, ids)
    extra = {k: counts[k] - ref_counts[k] for k in counts}
    n_layers = base.config.num_hidden_layers
    if policy == "everything_saveable":
        assert extra == {"mm": 0, "rsqrt": 0}
    elif policy in (None, "nothing_saveable"):
        # the recompute stops at the last tensor the backward needs: the
        # output projection of the MLP is not run again
        assert extra["mm"] >= 6 * n_layers and extra["rsqrt"] >= 2 * n_layers
    else:  # the layers' seven products are kept, the norms recomputed
        assert extra["mm"] == 0 and extra["rsqrt"] >= 2 * n_layers


def test_remat_dots_saveable_matches_jax():
    """JAX's ``remat_policy="dots_saveable"`` case: the loss within 1e-5
    relative and every gradient within 1e-5 absolute."""
    jmodel, params, tmodel = _pair(remat=True, remat_policy="dots_saveable")
    ids = _ids(2, (2, 32))
    jl, jg = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids)))(params)
    loss, grads = _port_loss_and_grads(tmodel, ids)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(lookup(jg, name)), atol=GRAD_ATOL,
                                   err_msg=name)


def test_unknown_remat_policy_raises():
    """As JAX: an unknown name is a ValueError naming ``remat_policy``; the
    offload policies need host offload and are not ported."""
    with pytest.raises(ValueError, match="remat_policy"):
        LlamaForCausalLM(LlamaConfig.tiny(remat=True, remat_policy="no_such_policy"),
                         device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        jax_init_llama(JaxLlamaConfig.tiny(remat=True, remat_policy="no_such_policy"))
    with pytest.raises(NotImplementedError, match="offload"):
        LlamaForCausalLM(LlamaConfig.tiny(remat=True,
                                          remat_policy="offload_dot_with_no_batch_dims"),
                         device="cpu")


def _engine_config(policy):
    cfg = {"train_batch_size": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0}
    if policy:
        cfg["activation_checkpointing"] = {"remat_policy": policy,
                                           "contiguous_memory_optimization": True}
    return cfg


def test_engine_level_remat_policy():
    """``activation_checkpointing.remat_policy`` wraps the whole forward:
    2 steps equal the port's engine without it bit for bit and match the
    JAX engine under the same config (micro 2 on one JAX device here, 2
    per device where the JAX engine sees more)."""
    jmodel, params, tmodel = _pair()
    _, _, plain_model = _pair()
    n_dev = jax.device_count()
    jcfg = dict(_engine_config("dots_saveable"), train_batch_size=2 * n_dev)
    jeng, *_ = deepspeed_tpu.initialize(model=jmodel, model_parameters=params, config=jcfg)
    tcfg = dict(_engine_config("dots_saveable"), train_batch_size=2 * n_dev)
    teng, *_ = deepspeed_tpu_torch.initialize(model=tmodel, config=tcfg, device="cpu")
    plain, *_ = deepspeed_tpu_torch.initialize(
        model=plain_model, config=dict(_engine_config(None), train_batch_size=2 * n_dev),
        device="cpu")
    for step in range(2):
        ids = _ids(10 + step, (2 * n_dev, 16))
        jl = jeng.forward(jnp.asarray(ids), labels=jnp.asarray(ids))
        jeng.backward(jl)
        jeng.step()
        t = torch.from_numpy(ids).long()
        losses = []
        for e in (teng, plain):
            loss = e.forward(t, labels=t)
            e.backward(loss)
            e.step()
            losses.append(loss.item())
        assert losses[0] == losses[1]
        np.testing.assert_allclose(losses[0], float(jl), rtol=LOSS_RTOL)
    assert torch.equal(teng.optimizer.params, plain.optimizer.params)
    jparams = jax.tree_util.tree_map(np.asarray, jeng.params)
    for name, m in teng.master_params().items():
        np.testing.assert_allclose(m.numpy(), np.asarray(lookup(jparams, name)),
                                   atol=2e-5, err_msg=name)
    with pytest.raises(ValueError, match="remat_policy"):
        deepspeed_tpu_torch.initialize(model=plain_model, config=_engine_config("nope"),
                                       device="cpu")


def test_checkpoint_api_and_rng_tracker():
    """``configure``/``checkpoint``/``checkpoint_wrapper`` as the JAX
    module's: the configured policy applies, the result and its gradient
    equal the plain call's; a named RNG stream drawn inside a checkpointed
    block gives the recompute the forward's draws."""
    checkpointing.configure(partition_activations=False)
    tracker = checkpointing.get_cuda_rng_tracker()
    tracker.reset()
    tracker.add("dropout", 1234, device="cpu")
    w = torch.randn(8, 8, generator=torch.Generator().manual_seed(0), requires_grad=True)

    def block(x):
        with tracker.fork("dropout"):
            keep = torch.rand(x.shape) > 0.5
        return torch.tanh((x @ w) * keep)

    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    states = tracker.get_states()
    ref = block(x)
    ref.sum().backward()
    g_ref = w.grad.clone()
    w.grad = None
    tracker.set_states(states)
    out = checkpointing.checkpoint_wrapper(block)(x)
    out.sum().backward()
    assert torch.equal(out, ref) and torch.equal(w.grad, g_ref)
    with pytest.raises(NotImplementedError, match="partition_activations"):
        checkpointing.configure(partition_activations=True)
    checkpointing.configure(partition_activations=False)
    with pytest.raises(NotImplementedError, match="cpu_checkpointing"):
        checkpointing.configure(checkpoint_in_cpu=True)
    checkpointing.configure(checkpoint_in_cpu=False)


def _mask(b, s, pads):
    m = np.ones((b, s), np.int32)
    for row, (left, right) in enumerate(pads):
        m[row, :left] = 0
        if right:
            m[row, s - right:] = 0
    return m


@pytest.mark.parametrize("case", ["plain", "window", "softcap", "remat"])
def test_attn_mask_matches_jax_dense_branch(case):
    """``attn_mask`` ``[b, s]`` against the JAX model's dense branch (the
    flash kernels refuse a mask there): row 0 left-padded by 5, so its
    first query rows see no key (JAX spreads them evenly over all keys),
    row 1 right-padded by 3; plain causal, with Mistral's window of 8,
    with the attention-logit softcap (the ``-1e30`` branch), and under
    remat. Loss 1e-5 relative, grads 1e-5 absolute."""
    over = {"plain": {}, "window": {"sliding_window": 8},
            "softcap": {"attn_logit_softcapping": 20.0},
            "remat": {"remat": True, "remat_policy": "dots_saveable"}}[case]
    jmodel, params, tmodel = _pair(**over)
    ids = _ids(3, (2, 24))
    mask = _mask(2, 24, [(5, 0), (0, 3)])
    jl, jg = jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids),
        attn_mask=jnp.asarray(mask)))(params)
    loss, grads = _port_loss_and_grads(tmodel, ids, attn_mask=mask)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(lookup(jg, name)), atol=GRAD_ATOL,
                                   err_msg=name)
    # the mask changes the result, and a mask of ones is the flash route's
    unmasked, _ = _port_loss_and_grads(tmodel, ids)
    assert unmasked.item() != loss.item()
    ones, _ = _port_loss_and_grads(tmodel, ids, attn_mask=np.ones_like(mask))
    np.testing.assert_allclose(ones.item(), unmasked.item(), rtol=1e-6)


def test_attn_mask_logits_match_jax():
    """The logits (no labels) under a mask, both rows padded left."""
    jmodel, params, tmodel = _pair()
    ids = _ids(4, (2, 20))
    mask = _mask(2, 20, [(3, 0), (7, 0)])
    ref = jmodel.apply({"params": params}, jnp.asarray(ids), attn_mask=jnp.asarray(mask))
    got = tmodel(torch.from_numpy(ids).long(), attn_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
