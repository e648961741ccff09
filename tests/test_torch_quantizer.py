"""deepspeed_tpu_torch blockwise int8 quantization (K6) against the JAX
package.

The same numpy inputs go through ``deepspeed_tpu.ops.quantizer`` (the
Pallas kernel in interpret mode, and its jnp branch) and the port's
``quantize_int8_blockwise``, which on CPU tensors takes the plain PyTorch
version. Both divide in IEEE fp32 and round half to even, and the absmax is
order-independent, so values and scales must be equal bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.linear.config import QuantizationConfig as JQuantConfig
from deepspeed_tpu.linear.quantization import QuantizedParameter as JQuantized
from deepspeed_tpu.ops.quantizer import dequantize_int8_blockwise as jax_dequant
from deepspeed_tpu.ops.quantizer import quantize_int8_blockwise as jax_quant
from deepspeed_tpu_torch.linear import QuantizationConfig, QuantizedParameter
from deepspeed_tpu_torch.models.convert import quantized_from_jax
from deepspeed_tpu_torch.ops.quantizer import (
    _pad_to_blocks, dequantize_int8_blockwise, quantize_int8_blockwise)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _weights(shape, seed):
    """Normal values with a ragged tail (numel not a multiple of 512), an
    all-zero 512-block, a block holding a single nonzero, and values that
    land on a half-way point of their block's grid."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[512:1024] = 0.0                   # block 1: all zeros, scale 1
    flat[1024:1536] = 0.0
    flat[1100] = -3.0                      # block 2: one value, codes 0 / -127
    flat[1536:1540] = [127.0, 0.5, -1.5, 2.5]  # block 3: scale 1, ties to even
    return x


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(37, 100), (64, 96), (4096 + 7, )])
@pytest.mark.parametrize("route", ["interpret", "jnp"])
def test_quantize_matches_jax_bit_for_bit(shape, dtype, route):
    x = _weights(shape, seed=len(shape) + shape[0])
    jd, td = DTYPES[dtype]
    kw = dict(interpret=True) if route == "interpret" else dict(force_pallas=False)
    vj, sj = jax_quant(jnp.asarray(x, jd), block_size=512, **kw)
    vt, st = quantize_int8_blockwise(torch.from_numpy(x).to(td), block_size=512)
    n_blocks = -(-x.size // 512)
    assert vt.dtype == torch.int8 and tuple(vt.shape) == (n_blocks * 512, )
    assert st.dtype == torch.float32 and tuple(st.shape) == (n_blocks, )
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
    assert st[1].item() == 1.0 and not vt[512:1024].any()  # the all-zero block
    assert st[3].item() == 1.0 and vt[1536:1540].tolist() == [127, 0, -2, 2]
    assert not vt[x.size:].any()  # the zero padding of the tail block


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dequantize_matches_jax_bit_for_bit(dtype):
    x = _weights((37, 100), seed=3)
    jd, td = DTYPES[dtype]
    vj, sj = jax_quant(jnp.asarray(x), block_size=512, force_pallas=False)
    vt, st = quantize_int8_blockwise(torch.from_numpy(x), block_size=512)
    want = jax_dequant(vj, sj, x.shape, 512).astype(jd)
    got = dequantize_int8_blockwise(vt, st, x.shape, 512, dtype=td)
    assert got.dtype == td and tuple(got.shape) == x.shape
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(want))
    out = torch.empty(x.shape, dtype=td)
    assert dequantize_int8_blockwise(vt, st, x.shape, 512, dtype=td, out=out) is out
    assert torch.equal(out, got)
    with pytest.raises(ValueError):
        dequantize_int8_blockwise(vt, st, x.shape, 512, dtype=td,
                                  out=torch.empty(x.shape[::-1], dtype=td))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_main_path_shape_matches_jax(dtype):
    """Llama-3-8B's k/v kernel ([4096, 1024]) at the engine's block of 512,
    with two all-zero blocks (scale 1). Against the jnp branch (IEEE
    division, as the port): bit for bit. Against the Pallas kernel in
    interpret mode, whose ``absmax / 127`` lands one fp32 ulp off in a few
    hundred of these 8192 blocks on the CPU: every other scale and every
    code of every other block equal, and in those blocks the scale one ulp
    away and each code within one."""
    rng = np.random.default_rng(11)
    x = (0.02 * rng.normal(size=(4096, 1024))).astype(np.float32)
    x.reshape(-1)[512 * 3:512 * 5] = 0.0
    jd, td = DTYPES[dtype]
    vt, st = quantize_int8_blockwise(torch.from_numpy(x).to(td), block_size=512)
    assert st[3:5].tolist() == [1.0, 1.0] and not vt[512 * 3:512 * 5].any()
    vj, sj = jax_quant(jnp.asarray(x, jd), block_size=512, force_pallas=False)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
    vk, sk = jax_quant(jnp.asarray(x, jd), block_size=512, interpret=True)
    ulps = np.abs(_bits(st.numpy()).astype(np.int64) - _bits(sk).astype(np.int64))
    assert ulps.max() <= 1
    codes = np.abs(vt.numpy().astype(np.int32) - np.asarray(vk, np.int32)).reshape(-1, 512)
    assert codes.max() <= 1 and not codes[ulps == 0].any()


def test_pad_to_blocks_pads_zeros():
    flat, pad = _pad_to_blocks(torch.arange(1, 8, dtype=torch.float32), 4)
    assert pad == 1 and flat.tolist() == [1, 2, 3, 4, 5, 6, 7, 0]
    flat, pad = _pad_to_blocks(torch.ones(8), 4)
    assert pad == 0 and flat.shape == (8, )


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantized_parameter_matches_jax(dtype):
    """A [in, out] kernel quantized as stored: the port's QuantizedParameter
    holds JAX's values and scales, restores its dtype, and the JAX object
    carried over by ``quantized_from_jax`` dequantizes to the same bits."""
    jd, td = DTYPES[dtype]
    w = _weights((64, 200), seed=7)
    jqp = JQuantized.quantize(jnp.asarray(w, jd), JQuantConfig())
    tqp = QuantizedParameter.quantize(torch.from_numpy(w).to(td), QuantizationConfig())
    assert tqp.block_size == jqp.block_size == 512
    assert tqp.shape == jqp.shape and tqp.dtype == td and tqp.nbytes == jqp.nbytes
    carried = quantized_from_jax(jqp, device="cpu")
    assert torch.equal(carried.values, tqp.values)
    assert torch.equal(carried.scales, tqp.scales)
    assert carried.dtype == td and carried.shape == tqp.shape
    back = tqp.dequantized()
    assert back.dtype == td and tuple(back.shape) == w.shape
    np.testing.assert_array_equal(_bits(back.float().numpy()),
                                  _bits(np.asarray(jqp.dequantized())))
    # the round trip is within half a code of each block's scale
    scale = np.repeat(tqp.scales.numpy(), 512)[:w.size].reshape(w.shape)
    ref = torch.from_numpy(w).to(td).float().numpy()
    slack = 0.5 * scale + (2.0 ** -8 * np.abs(ref) if td == torch.bfloat16 else 0.0)
    assert np.all(np.abs(back.float().numpy() - ref) <= slack * (1 + 1e-6))


@pytest.mark.parametrize("kwargs, error", [
    (dict(config=QuantizationConfig(q_bits=6)), NotImplementedError),
    (dict(config=QuantizationConfig(q_bits=4)), NotImplementedError),
    (dict(config=QuantizationConfig(q_bits=5)), ValueError),
    (dict(shard_dim=0, shards=2), NotImplementedError),
])
def test_quantized_parameter_refuses_unported_layouts(kwargs, error):
    with pytest.raises(error):
        QuantizedParameter.quantize(torch.ones(8, 8), **kwargs)
    # shard_dim with one shard is the flat layout, as in the JAX class
    qp = QuantizedParameter.quantize(torch.ones(8, 8), shard_dim=0, shards=1)
    assert qp.shards == 1 and torch.equal(qp.dequantized(), torch.ones(8, 8))
