"""fqtk_tpu_torch.ops.device_encoding against the JAX functions it ports
(exact: the outputs are small integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqtk_tpu.core.encoding import ENCODE_LUT, NOCALL_LUT
from fqtk_tpu.ops import device_encoding as jax_enc
from fqtk_tpu_torch.ops import device_encoding as torch_enc

ALL_BYTES = np.arange(256, dtype=np.uint8).reshape(16, 16)


def test_byte_to_mask_all_bytes():
    got = torch_enc.byte_to_mask(torch.from_numpy(ALL_BYTES))
    assert got.dtype == torch.int32
    want = np.asarray(jax_enc.byte_to_mask(jnp.asarray(ALL_BYTES)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ENCODE_LUT[ALL_BYTES])


def test_byte_is_nocall_all_bytes():
    got = torch_enc.byte_is_nocall(torch.from_numpy(ALL_BYTES))
    assert got.dtype == torch.int32
    want = np.asarray(jax_enc.byte_is_nocall(jnp.asarray(ALL_BYTES)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), NOCALL_LUT[ALL_BYTES])


@pytest.mark.parametrize("length", [1, 4, 5, 9, 16, 17, 33])
def test_unpack_bit2_matches_jax(length):
    rng = np.random.default_rng(100 + length)
    packed = rng.integers(0, 256, size=(37, -(-length // 4)), dtype=np.uint8)
    got = torch_enc.unpack_bit2(torch.from_numpy(packed), length)
    want = np.asarray(jax_enc.unpack_bit2(jnp.asarray(packed), length))
    assert got.dtype == torch.int32 and tuple(got.shape) == (37, length)
    np.testing.assert_array_equal(got.numpy(), want)
    # lowest bit pair is the first position
    np.testing.assert_array_equal(got.numpy()[:, 0], packed[:, 0] & 3)


@pytest.mark.parametrize("length", [1, 4, 5, 9, 16, 17, 33])
def test_unpack_nib4_matches_jax(length):
    rng = np.random.default_rng(200 + length)
    packed = rng.integers(0, 256, size=(37, -(-length // 2)), dtype=np.uint8)
    got = torch_enc.unpack_nib4(torch.from_numpy(packed), length)
    want = np.asarray(jax_enc.unpack_nib4(jnp.asarray(packed), length))
    assert got.dtype == torch.int32 and tuple(got.shape) == (37, length)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("length", [1, 4, 5, 9, 16, 17, 33])
def test_pack_bit2_roundtrips_through_jax_unpack(length):
    rng = np.random.default_rng(300 + length)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    codes = rng.integers(0, 4, size=(23, length))
    packed = torch_enc.pack_bit2(acgt[codes])
    assert packed.dtype == np.uint8 and packed.shape == (23, -(-length // 4))
    np.testing.assert_array_equal(
        np.asarray(jax_enc.unpack_bit2(jnp.asarray(packed), length)), codes
    )
    with pytest.raises(ValueError, match="A, C, G, T"):
        torch_enc.pack_bit2(np.frombuffer(b"ACGN", dtype=np.uint8)[None, :])
