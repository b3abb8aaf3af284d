"""The port's quasi-cyclic matrix (``ldpc_tpu_torch/codes/qc.py``) against
the JAX package's: the same dense round trip and validation, and, for one
numpy seed, the same proposals in the same order (the optimizer's proposal
sequence depends on it). Integers, so every comparison is exact."""
import os

import numpy as np
import pytest

from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.codes.qc import QCMatrix

try:  # the card's host has no JAX (whose package this module's import runs)
    from ldpc_tpu.codes.qc import QCMatrix as JaxQC
except ImportError:
    JaxQC = None

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


@pytest.mark.parametrize("name", ["optimalH.txt", "optimalH_tpu.txt"])
def test_round_trip_committed_matrix(name):
    h = read_pcm(os.path.join(DATA, name))
    qc = QCMatrix.from_dense(h, 20)
    assert qc.present.shape == (8, 14)
    np.testing.assert_array_equal(qc.to_dense(), h)
    want = JaxQC.from_dense(h, 20)
    np.testing.assert_array_equal(qc.present, want.present)
    np.testing.assert_array_equal(qc.shifts, want.shifts)


def test_dense_structure():
    qc = QCMatrix(4, np.array([[True, False]]), np.array([[1, 0]]))
    h = qc.to_dense()
    assert h.shape == (4, 8)
    for k in range(4):          # shifted identity: row k's 1 at (1 + k) % 4
        assert h[k, (1 + k) % 4] == 1 and h[k].sum() == 1
    assert not h[:, 4:].any()


@pytest.mark.parametrize("case", ["partial", "two_shifts", "not_divisible"])
def test_non_shifted_identity_blocks_rejected(case):
    h = np.zeros((4, 8), np.uint8)
    if case == "partial":
        h[0, 0] = 1                       # not a full shifted identity
    elif case == "two_shifts":
        h[:, :4] = np.eye(4, dtype=np.uint8)
        h[[0, 1]] = h[[1, 0]]             # a permutation, not a shift
    else:
        h = np.zeros((4, 6), np.uint8)
    with pytest.raises(ValueError):
        QCMatrix.from_dense(h, 4)
    with pytest.raises(ValueError):
        JaxQC.from_dense(h, 4)


def test_proposals_equal_jax_for_one_seed():
    """200 mutations and 3 rejection-sampled random matrices from one
    seed: the same present and shifts in both packages, and the two
    generators left in the same state."""
    rng, jrng = np.random.default_rng(239), np.random.default_rng(239)
    qc = QCMatrix.random(rng, 20, 8, 14)
    jqc = JaxQC.random(jrng, 20, 8, 14)
    for step in range(200):
        qc, jqc = qc.random_mutation(rng), jqc.random_mutation(jrng)
        np.testing.assert_array_equal(qc.present, jqc.present,
                                      err_msg=f"mutation {step}")
        np.testing.assert_array_equal(qc.shifts, jqc.shifts,
                                      err_msg=f"mutation {step}")
    for draw in range(2):
        qc, jqc = (QCMatrix.random(rng, 20, 8, 14),
                   JaxQC.random(jrng, 20, 8, 14))
        np.testing.assert_array_equal(qc.present, jqc.present,
                                      err_msg=f"random {draw}")
        np.testing.assert_array_equal(qc.shifts, jqc.shifts,
                                      err_msg=f"random {draw}")
        assert gf2_nullspace(qc.to_dense())[1]
    assert rng.integers(1 << 30) == jrng.integers(1 << 30)


def test_unregular_draw_returns_first_sample():
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    qc = QCMatrix.random(rng, 4, 3, 5, require_regular=False)
    jqc = JaxQC.random(jrng, 4, 3, 5, require_regular=False)
    np.testing.assert_array_equal(qc.present, jqc.present)
    np.testing.assert_array_equal(qc.shifts, jqc.shifts)
    mut = qc.random_mutation(rng)
    touched = np.argwhere((qc.present != mut.present)
                          | (qc.shifts != mut.shifts))
    assert len(touched) <= 1
