"""The plain reference against scipy.sparse, and the TF32 control."""

import numpy as np
import pytest
import scipy.sparse
import torch

from spmm_bench import reference
from spmm_bench.operands import Operand


def csr_operand(rng, m, k, density):
    s = scipy.sparse.random(m, k, density=density, format="csr",
                            random_state=rng, dtype=np.float64)
    s.data = rng.integers(-2, 3, s.nnz).astype(np.float64)
    op = Operand("a", (m, k), torch.from_numpy(s.indptr.astype(np.int64)),
                 torch.from_numpy(s.indices.astype(np.int64)),
                 torch.from_numpy(s.data.astype(np.float32)))
    return op, s


def bsr_operand(rng, m, k, bh, bw, keep):
    nbr, nbc = m // bh, k // bw
    mask = rng.random((nbr, nbc)) < keep
    blocks = rng.standard_normal((int(mask.sum()), bh, bw)).astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
    indices = np.nonzero(mask)[1]
    s = scipy.sparse.bsr_matrix((blocks.astype(np.float64), indices, indptr),
                                shape=(m, k))
    op = Operand("w", (m, k), torch.from_numpy(indptr.astype(np.int64)),
                 torch.from_numpy(indices.astype(np.int64)),
                 torch.from_numpy(blocks), block=(bh, bw))
    return op, s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_equals_scipy(dtype):
    rng = np.random.default_rng(1)
    b = torch.from_numpy(rng.uniform(-1, 1, (96, 24))).to(dtype)
    b64 = b.double().numpy()
    for op, s in (csr_operand(rng, 40, 96, 0.1),
                  bsr_operand(rng, 64, 96, 16, 32, 0.4)):
        want = s @ b64
        got = reference.product(op, b)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12)


def test_reference_works_in_blocks(monkeypatch):
    rng = np.random.default_rng(2)
    b = torch.from_numpy(rng.uniform(-1, 1, (64, 8)))
    for op, s in (csr_operand(rng, 50, 64, 0.2),
                  bsr_operand(rng, 64, 64, 8, 16, 0.5)):
        whole = reference.product(op, b)
        monkeypatch.setattr(reference, "CHUNK_BYTES", 1)
        np.testing.assert_allclose(reference.product(op, b).numpy(),
                                   whole.numpy(), rtol=1e-13, atol=1e-13)
        monkeypatch.undo()


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -3.0, 1.0 + 2**-12])
    got = reference.round_tf32(x)
    # to nearest, ties to even: 1 + 2^-11 -> 1, 1 + 3·2^-11 -> 1 + 2^-9
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, -3.0, 1.0])
    assert torch.equal(got, want)
    bf16 = torch.randn(100).to(torch.bfloat16).float()
    assert torch.equal(reference.round_tf32(bf16), bf16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_control_misses_what_the_serve_keeps(dtype):
    """Integer A and a bf16 B are exact in TF32: the bf16 serve's control
    is fp8, which is not."""
    rng = np.random.default_rng(3)
    op, _ = csr_operand(rng, 64, 512, 0.2)
    b = torch.from_numpy(rng.uniform(-1, 1, (512, 32)).astype(np.float32))
    b = b.to(dtype)
    ref = reference.product(op, b)
    name, rounding = reference.CONTROLS[str(dtype).split(".")[-1]]
    control = reference.product(op, b, control=rounding)
    assert reference.max_rel_err(ref.float(), ref) < 1e-6
    assert reference.max_rel_err(control, ref) > 1e-4
    if dtype == torch.bfloat16:
        tf32 = reference.product(op, b, control=reference.round_tf32)
        assert reference.max_rel_err(tf32, ref) < 1e-6


def test_round_fp8_keeps_three_mantissa_bits_under_one_scale():
    x = torch.tensor([448.0, 1.0 * 448 / 2, 240.0, -100.0, 0.0])
    assert torch.equal(reference.round_fp8(x),
                       torch.tensor([448.0, 224.0, 240.0, -96.0, 0.0]))
    y = torch.tensor([0.5, 0.3])   # scaled by 896: 448 and 268.8 -> 256
    assert torch.allclose(reference.round_fp8(y),
                          torch.tensor([0.5, 256 / 896]))


def test_max_rel_err_refuses_what_is_not_an_answer():
    ref = torch.ones(3, 2, dtype=torch.float64)
    assert reference.max_rel_err(None, ref) == float("inf")
    assert reference.max_rel_err(torch.ones(2, 3), ref) == float("inf")
    bad = torch.ones(3, 2)
    bad[1, 1] = float("nan")
    assert reference.max_rel_err(bad, ref) == float("inf")
    assert reference.max_rel_err(torch.ones(3, 2), ref) == 0.0
