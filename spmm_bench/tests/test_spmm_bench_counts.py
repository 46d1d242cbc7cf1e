"""The benchmark's operation and byte counts on operands worked by hand."""

import pytest
import torch

from spmm_bench import counts
from spmm_bench.operands import Operand

H100 = "NVIDIA H100 80GB HBM3"


def csr_3x4():
    # entries (0, 1), (0, 3), (2, 1): B rows 1 and 3 are read
    return Operand("csr", (3, 4), indptr=torch.tensor([0, 2, 2, 3]),
                   indices=torch.tensor([1, 3, 1]),
                   values=torch.tensor([1.0, 2.0, 3.0]))


def bsr_256x384():
    # blocks (0, 0) and (1, 2) of 128 x 128: B rows 0-127 and 256-383
    return Operand("bsr", (256, 384), indptr=torch.tensor([0, 1, 2]),
                   indices=torch.tensor([0, 2]),
                   values=torch.ones(2, 128, 128), block=(128, 128))


def test_csr_counts_by_hand():
    c = csr_3x4().counts()
    assert c == counts.OperandCounts(rows=3, cols=4, stored=3, indices=3,
                                     pointers=4, touched_cols=2)
    assert counts.flops(c, 8) == 2 * 3 * 8
    # values 3·4, indices and pointers (3 + 4)·4, B 2 rows · 8 · 4, C 3·8·4
    assert counts.min_bytes(c, 8, "float32") == 12 + 28 + 64 + 96
    # a bf16 B row is half the bytes
    assert counts.min_bytes(c, 8, "bfloat16") == 12 + 28 + 32 + 96


def test_bsr_counts_one_index_a_block():
    c = bsr_256x384().counts()
    assert c == counts.OperandCounts(rows=256, cols=384, stored=32768,
                                     indices=2, pointers=3, touched_cols=256)
    assert counts.flops(c, 16) == 2 * 32768 * 16
    assert counts.min_bytes(c, 16, "bfloat16") == (
        32768 * 4 + (2 + 3) * 4 + 256 * 16 * 2 + 256 * 16 * 4)


def test_least_time_is_the_larger_bound():
    c = bsr_256x384().counts()
    p = counts.peak(H100)
    mem = counts.min_bytes(c, 16, "bfloat16") / p["hbm_bytes_per_s"]
    ops = counts.flops(c, 16) / p["flops_per_s"]["bfloat16"]
    assert counts.least_seconds(c, 16, "bfloat16", H100) == max(mem, ops)
    # at a wide B the same operand's bound moves to the tensor cores' rate
    wide = 1 << 16
    assert counts.least_seconds(c, wide, "float32", H100) >= \
        counts.flops(c, wide) / 495e12


def test_a_card_not_in_the_table_has_no_peak():
    with pytest.raises(KeyError, match="no published peaks"):
        counts.least_seconds(csr_3x4().counts(), 8, "float32",
                             "NVIDIA H100 PCIe")
