"""Host layer of the PyTorch port against the JAX package, on every committed
parity-check matrix: file reading, Tanner-graph tables, GF(2) algebra."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpc_tpu.codes import gf2 as jgf2
from ldpc_tpu.codes.graph import CodeGraph as JCodeGraph
from ldpc_tpu.codes.io import read_pcm as jread_pcm
from ldpc_tpu_torch.codes import gf2, io
from ldpc_tpu_torch.codes.graph import CodeGraph

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
MATRICES = ["H", "optimalH", "optimalH_tpu", "H05", "H02"]
TABLES = ["h", "row_col", "row_mask", "row_deg", "col_row", "col_mask",
          "col_deg", "row_from_col", "col_from_row"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _path(name):
    return os.path.join(DATA, f"{name}.txt")


@pytest.mark.parametrize("name", MATRICES)
def test_read_pcm_matches_jax(name):
    h = io.read_pcm(_path(name))
    ref = jread_pcm(_path(name))
    assert h.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(h, ref)


@pytest.mark.parametrize("name", MATRICES)
def test_code_graph_matches_jax(name):
    h = io.read_pcm(_path(name))
    g, ref = CodeGraph.from_h(h), JCodeGraph.from_h(h)
    for f in ("m", "n", "n_edges", "dc_max", "dv_max"):
        assert getattr(g, f) == getattr(ref, f), f
    for f in TABLES:
        a, b = getattr(g, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    carried = CodeGraph.from_arrays(ref.__dict__)
    for f in TABLES:
        np.testing.assert_array_equal(getattr(carried, f), getattr(ref, f))


@pytest.mark.parametrize("name", MATRICES)
def test_gf2_matches_jax(name):
    h = io.read_pcm(_path(name))
    g, ok = gf2.gf2_nullspace(h)
    g_ref, ok_ref = jgf2.gf2_nullspace(h)
    assert ok == ok_ref
    np.testing.assert_array_equal(g, g_ref)
    assert gf2.gf2_rank(h) == jgf2.gf2_rank(h)
    np.testing.assert_array_equal(gf2.gf2_matmul(h, g.T),
                                  jgf2.gf2_matmul(h, g.T))
    # is_codeword on the generator's rows (all valid) and on flipped rows
    rng = np.random.default_rng(0)
    words = g[rng.integers(0, g.shape[0], 16)].copy()
    words[8:, 0] ^= 1
    flags = gf2.is_codeword(torch.from_numpy(h), torch.from_numpy(words))
    ref_flags = jgf2.is_codeword(jnp.asarray(h), jnp.asarray(words))
    np.testing.assert_array_equal(flags.numpy(), np.asarray(ref_flags))
    np.testing.assert_array_equal(
        gf2.syndrome(torch.from_numpy(h), torch.from_numpy(words)).numpy(),
        np.asarray(jgf2.syndrome(jnp.asarray(h), jnp.asarray(words))))


def test_gf2_nullspace_singular():
    h = np.array([[1, 1, 0], [0, 0, 0]], dtype=np.uint8)
    assert gf2.gf2_nullspace(h) == (None, False)
    assert jgf2.gf2_nullspace(h)[1] is False


def test_code_graph_from_arrays_rejects_bad_shape():
    ref = JCodeGraph.from_h(io.read_pcm(_path("H")))
    arrays = dict(ref.__dict__, row_col=ref.row_col[:, :-1])
    with pytest.raises(ValueError, match="row_col"):
        CodeGraph.from_arrays(arrays)


def test_io_roundtrip(tmp_path):
    h = io.read_pcm(_path("H"))
    p = tmp_path / "h.txt"
    io.save_matrix(h, str(p))
    np.testing.assert_array_equal(io.read_pcm(str(p)), h)
    from ldpc_tpu.codes.io import read_codewords as jread_codewords
    cws = io.read_codewords(os.path.join(DATA, "codewords.txt"))
    np.testing.assert_array_equal(
        cws, jread_codewords(os.path.join(DATA, "codewords.txt")))
