"""Port parity: ``repro_torch.core.hashing`` against ``repro.core.hashing``.

Every register comparison of the port rests on the hash, so (bucket, rho)
must equal the JAX package's element for element: the int64-emulated
uint32 arithmetic, the split multiplies and the integer clz leave no
room for a tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hashing as jax_hashing  # noqa: E402
from repro_torch.core import hashing  # noqa: E402


def _keys() -> np.ndarray:
    rng = np.random.default_rng(2024)
    edge = np.array([0, 1, 2 ** 32 - 1], dtype=np.uint32)
    rand = rng.integers(0, 2 ** 32, size=10_000, dtype=np.uint64)
    return np.concatenate([edge, rand.astype(np.uint32)])


@pytest.mark.parametrize("seed", [0, 1, 12345])
@pytest.mark.parametrize("p", [4, 8, 12, 16])
def test_bucket_rho_matches_jax(p, seed):
    keys = _keys()
    jb, jr = jax_hashing.bucket_rho(keys, p, seed)
    tb, tr = hashing.bucket_rho(torch.from_numpy(keys), p, seed)
    assert tb.dtype == torch.int32 and tr.dtype == torch.uint8
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_hash64_lanes_match_jax():
    keys = _keys()
    jhi, jlo = jax_hashing.hash64(keys, seed=7)
    thi, tlo = hashing.hash64(torch.from_numpy(keys), seed=7)
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi).astype(np.int64))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo).astype(np.int64))


def test_clz32_edge_values():
    x = torch.tensor([0, 1, 2, 3, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                      0xFFFFFFFF], dtype=torch.int64)
    expect = [32, 31, 30, 30, 16, 15, 1, 0, 0]
    assert hashing.clz32(x).tolist() == expect


def test_bucket_rho_rejects_bad_p():
    with pytest.raises(ValueError):
        hashing.bucket_rho(torch.zeros(3, dtype=torch.int64), 0)
