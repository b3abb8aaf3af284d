"""QP-ADMM's iteration kernel (``csrc/admm_iterate.cu``) and its plain twin
(``ops/admm_ref.py``) in the PyTorch port.

On the CPU: the twin ``admm_iterate_ref`` equals the JAX package's
iteration, ``_admm_setup(...)``'s ``iter_fn``
(``ldpc_tpu/decoders/admm.py:205-264``) looped as JAX's stream body loops
it (``:351-356``), with ``torch.equal`` in v, z, yl, done and the
iteration counts after 1, 32 and 300 iterations, on numpy inputs from a
seed: ``data/H.txt`` and optimalH at 16 lanes, ``max_iter`` cut in the
middle of a chunk, lanes already done at entry, per-lane (alpha, mu), a
population of two candidates (optimalH and H05) padded to shared caps, and
more than 32 slots a variable, which XLA sums in windows of 32 (H02 at
alpha 0.9, mu 0.5, optimalH at caps of 33 and 36 slots, and a star code
whose 1,200 slots need windows of windows); ``xla_sum`` equals a jitted
``jnp.sum``. The wrapper runs the twin on a CPU tensor; the packed tables,
the launch plan and an emulation of the kernel's data flow are checked
here too.

On the card (marked ``gpu``; ``python -m pytest
tests/test_torch_admm_kernel.py -m gpu --noconftest``): the kernel against
the twin on the same cases plus H02 at 64 lanes, the optimizer's
population, each of the four tiers (the incumbents at caps of the third,
a 640 x 1280 code of row weight 6 and optimalH at caps of 9,000 / 10,000
in the global one), XLA's windows past 32 slots in every tier (optimalH
at caps of 33 and 36 in the first, H02 in the second, the incumbents at
caps of 72 in the third, H02 at caps of 600 and a star code of 1,200
slots a variable in the global one) and the edge cases of the block's
queue and padding,
after 1, 32 and 512 iterations and for whole batched decodes; and each
pair's sum2 the same at any caps and in any tier. v, z, yl and the counts must be
equal on every pair whose stop agrees; a pair whose stop differs passes
only as a tie: both sum2 values at the earlier stop on either side of
eps_stop within n_con * 2**-23 * sum2 (the kernel sums sum2 in its own
order), after reruns that reach equal states.
"""
import json
import os

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.channel.awgn import llr_variance
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.apps.optimize_h import _caps_for
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.codes.qc import QCMatrix
from ldpc_tpu_torch.config import OptimizeConfig
from ldpc_tpu_torch.decoders import admm
from ldpc_tpu_torch.decoders.admm import (TABLES, ADMMStructure,
                                          QPADMMDecoder, _structure_caps)
from ldpc_tpu_torch.ops import admm_kernel
from ldpc_tpu_torch.ops.admm_kernel import (admm_iterate, admm_plan,
                                            pack_tables)
from ldpc_tpu_torch.ops.admm_ref import (admm_iterate_ref, lane_param,
                                         stop_ties, xla_sum)

try:  # the card's host has no JAX; only the gpu cases run there
    import jax
    import jax.numpy as jnp
    from ldpc_tpu.decoders import admm as jadmm
except ImportError:
    jnp = None

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CPU = torch.device("cpu")
EPS = 1e-5
# name: (matrices, lanes, SNR dB, alpha, mu, max_iter, per-lane params,
# lanes done at entry)
CASES = {
    "H": (("H",), 16, -1.0, 1.2, 0.55, 10000, False, False),
    "optimalH": (("optimalH",), 16, -3.0, 1.2, 0.55, 10000, False, False),
    "cut": (("H",), 16, -1.0, 1.2, 0.55, 20, False, False),
    "done": (("optimalH",), 16, -3.0, 1.2, 0.55, 10000, False, True),
    "params": (("H",), 16, -1.0, None, None, 10000, True, False),
    "population": (("optimalH", "H05"), 16, -3.0, 1.95, 0.5, 10000, False,
                   False),
    # more than 32 slots a variable: XLA's windows of 32. H02 (k 72) at the
    # feasible pair of scripts/run_h02_bench.sh, and optimalH at caps of 33
    # (front 15, back 16) and of 36 (boundaries inside quads of slots)
    "h02_feasible": (("H02",), 16, -5.0, 0.9, 0.5, 10000, False, False),
    "optimalH@k33": (("optimalH@k33",), 16, -3.0, 1.2, 0.55, 10000, False,
                     False),
    "optimalH@k36": (("optimalH@k36",), 16, -3.0, 1.2, 0.55, 10000, False,
                     False),
}
# on the card also: H02; the optimizer's population (the state file's 8
# incumbents at their caps 1280 / 5120 / 32, real counts 700-1160 /
# 2320-4160); H02 at (0.9, 0.5) in the global tier (caps of 600 slots:
# windows past the register tiers' 511) and the star code (1,200 slots a
# variable: XLA's second level of windows); a batch that is no multiple of
# the lanes per block; lanes done at entry beside lanes at -3 and +2 dB
# (stops far apart); and a population whose padding premise fails
# (non-finite q, padding z and yl off +0 at entry: PREMISE)
GPU_CASES = dict(CASES,
                 H02=(("H02",), 64, -3.0, 1.2, 0.55, 10000, False, False),
                 incumbents=(("incumbents",), 32, -3.0, 1.95, 0.5, 1000,
                             False, False),
                 tier2=(("incumbents@tier2",), 32, -3.0, 1.95, 0.5, 1000,
                        False, False),
                 wide=(("wide",), 16, 2.0, 1.2, 0.55, 1000, False, False),
                 global_caps=(("optimalH@global",), 16, -3.0, 1.2, 0.55,
                              10000, False, False),
                 h02_global=(("H02@k600",), 16, -5.0, 0.9, 0.5, 10000,
                             False, False),
                 star=(("star",), 16, -3.0, 1.2, 0.55, 1000, False, False),
                 ragged=(("optimalH",), 13, -3.0, 1.2, 0.55, 10000, False,
                         False),
                 mixed=(("optimalH",), 16, (-3.0, 2.0), 1.2, 0.55, 10000,
                        False, True),
                 premise=(("optimalH", "H05"), 16, -3.0, 1.95, 0.5, 10000,
                          False, False))
# caps that put a code in a given tier (``_case``'s ``name@caps``): the
# third tier (512 threads, 1 lane; the incumbents' caps past 5,120
# constraints), the global tier (tables read from device memory; a shape
# that needs 118 KB of v, t and b beside 253 KB of tables)
CAPS = {"tier2": dict(n_var_cap=2048, n_con_cap=6144, k_max_cap=72),
        "global": dict(n_var_cap=9000, n_con_cap=10000, k_max_cap=24),
        "caps": dict(n_var_cap=1280, n_con_cap=5120, k_max_cap=32),
        "k33": dict(k_max_cap=33), "k36": dict(k_max_cap=36),
        "k600": dict(k_max_cap=600)}
# the premise case's lanes: q NaN, q +inf, and at entry a padding z of
# 0.5, a padding yl of NaN, a padding yl of -0.0
PREMISE = {"nan_q": 0, "inf_q": 1, "pad_z": 2, "pad_yl": 3, "neg_yl": 4}
# per-lane (alpha, mu): the defaults, a wide pair, one failing the
# precondition on H.txt (e_min 8: 8 * 0.5 <= 5)
PAIRS = ((1.2, 0.55), (0.5, 2.5), (5.0, 0.5))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _llrs(h, lanes, snr, seed):
    """Channel LLRs (float32) of random codewords, made with numpy from a
    seed."""
    g, _ = gf2_nullspace(h)
    rng = np.random.default_rng(seed)
    cw = (rng.integers(0, 2, (lanes, g.shape[0])) @ g) % 2
    var = llr_variance(snr)
    y = 1.0 - 2.0 * cw + np.sqrt(var) * rng.standard_normal(cw.shape)
    return (2.0 * y / var).astype(np.float32)


def _case(name, cases=CASES):
    """Numpy inputs of a case: per-candidate tables (padded to shared caps
    for a population), LLRs (P, B, n), alpha and mu (B,) float32, max_iter,
    and done and it at entry (B, P)."""
    mats, lanes, snr, alpha, mu, max_iter, per_lane, pre_done = cases[name]
    mat, at = mats[0].split("@") if "@" in mats[0] else (mats[0], "")
    hs = (_incumbents() if mat == "incumbents" else [_wide()]
          if mat == "wide" else [_star()] if mat == "star" else
          [read_pcm(os.path.join(DATA, f"{m.split('@')[0]}.txt"))
           for m in mats])
    caps = {}
    if at:
        caps = CAPS[at]
    elif mat == "incumbents":
        caps = _caps_for(hs)
    elif len(hs) > 1:
        need = np.max([_structure_caps(h) for h in hs], axis=0)
        caps = dict(n_var_cap=int(need[0]) + 9, n_con_cap=int(need[1]) + 17,
                    k_max_cap=int(need[2]) + 2)
    structs = [ADMMStructure.from_h(h, **caps) for h in hs]
    snrs = snr if isinstance(snr, tuple) else (snr,)
    llrs = np.stack([_llrs(h, lanes, snrs[0], 40 + i) for i, h in
                     enumerate(hs)])
    for j, other in enumerate(snrs[1:], start=1):   # every len(snrs)-th lane
        llrs[:, j::len(snrs)] = np.stack(
            [_llrs(h, lanes, other, 40 + i) for i, h in enumerate(hs)]
        )[:, j::len(snrs)]
    if name == "premise":
        llrs[:, PREMISE["nan_q"], 5] = np.nan
        llrs[:, PREMISE["inf_q"], 7] = np.inf
    if per_lane:
        alpha = np.array([PAIRS[i % 3][0] for i in range(lanes)], np.float32)
        mu = np.array([PAIRS[i % 3][1] for i in range(lanes)], np.float32)
    else:
        alpha = np.full(lanes, alpha, np.float32)
        mu = np.full(lanes, mu, np.float32)
    done = np.zeros((lanes, len(hs)), bool)
    it = np.zeros((lanes, len(hs)), np.int32)
    if pre_done:
        done[::3] = True
        it[::3] = 7
    return structs, llrs, alpha, mu, max_iter, done, it


def _jax_start(structs, llrs, alpha, mu):
    """JAX's initial state per candidate (q, v0, z0, y0) as numpy (B, P *
    n) rows, and each candidate's jitted ``iter_fn`` per distinct (alpha,
    mu) pair with the lanes it serves."""
    qs, vs, zs, ys, fns = [], [], [], [], []
    for p, s in enumerate(structs):
        tables = {k: jnp.asarray(getattr(s, k)) for k in TABLES}
        q, _, v0, z0, y0, _ = jadmm._admm_setup(
            tables, s.n, jnp.asarray(llrs[p]), np.float32(alpha[0]),
            np.float32(mu[0]), EPS)
        per_pair = []
        for a, m in sorted(set(zip(alpha.tolist(), mu.tolist()))):
            lanes = np.nonzero((alpha == np.float32(a))
                               & (mu == np.float32(m)))[0]
            fn = jadmm._admm_setup(tables, s.n, jnp.asarray(llrs[p][lanes]),
                                   np.float32(a), np.float32(m), EPS)[5]
            per_pair.append((lanes, jax.jit(fn)))
        qs.append(np.asarray(q))
        vs.append(np.asarray(v0))
        zs.append(np.asarray(z0))
        ys.append(np.asarray(y0))
        fns.append(per_pair)
    return [np.concatenate(x, axis=1) for x in (qs, vs, zs, ys)], fns


def _jax_iterate(structs, fns, start, done, it, max_iter, iters):
    """``iters`` passes of JAX's stream body (``:351-356``): each candidate
    with its own ``iter_fn``, each lane with its (alpha, mu)."""
    q, v, z, yl = (jnp.asarray(x) for x in start)
    done, it = jnp.asarray(done), jnp.asarray(it)
    nv, nc = structs[0].n_var, structs[0].n_con
    for _ in range(iters):
        nv_parts, nz_parts, ny_parts, now = [], [], [], []
        for p, per_pair in enumerate(fns):
            sv, sc = slice(p * nv, (p + 1) * nv), slice(p * nc, (p + 1) * nc)
            vp, zp, yp = v[:, sv], z[:, sc], yl[:, sc]
            nd = jnp.zeros(done.shape[0], bool)
            for lanes, fn in per_pair:
                a, b, c, d = fn(q[lanes, sv], vp[lanes], zp[lanes],
                                yp[lanes], done[lanes, p])
                vp, zp, yp = (x.at[lanes].set(w) for x, w in
                              ((vp, a), (zp, b), (yp, c)))
                nd = nd.at[lanes].set(d)
            nv_parts.append(vp)
            nz_parts.append(zp)
            ny_parts.append(yp)
            now.append(nd)
        v = jnp.concatenate(nv_parts, axis=1)
        z = jnp.concatenate(nz_parts, axis=1)
        yl = jnp.concatenate(ny_parts, axis=1)
        it = it + (~done).astype(jnp.int32)
        done = done | jnp.stack(now, axis=1) | (it >= max_iter)
    return [np.array(x) for x in (v, z, yl, done, it)]


def _incumbents():
    """The non-singular chain incumbents of ``data/optimize_state.json``
    (the optimizer's population, 160 x 280)."""
    with open(os.path.join(DATA, "optimize_state.json")) as f:
        chains = json.load(f)["chains"]
    hs = [QCMatrix(OptimizeConfig().block_size, np.array(c["present"], bool),
                   np.array(c["shifts"], np.int64)).to_dense()
          for c in chains]
    return [h for h in hs if gf2_nullspace(h)[1]]


def _wide():
    """A 640 x 1280 quasi-cyclic code from a seed, column weight 3 and
    row weight 6 (circulants of 160; block row i leaves out block columns
    2i and 2i + 1): a cascade of (3200, 10240, 12), which needs the global
    tier."""
    present = np.ones((4, 8), bool)
    for i in range(4):
        present[i, 2 * i:2 * i + 2] = False
    shifts = np.random.default_rng(7).integers(0, 160, (4, 8))
    return QCMatrix(160, present, shifts).to_dense()


def _star():
    """300 checks of degree 3 that all hold variable 0 (check i: 0, 2i + 1,
    2i + 2): a cascade of (601, 1200, 1200) whose variable 0 fills 1,200
    slots, past the 1,024 of one level of XLA's windows."""
    h = np.zeros((300, 601), np.uint8)
    h[:, 0] = 1
    h[np.arange(300), 2 * np.arange(300) + 1] = 1
    h[np.arange(300), 2 * np.arange(300) + 2] = 1
    return h


def _tables(structs, device):
    return {k: torch.from_numpy(np.stack([getattr(s, k) for s in structs]))
            .to(device) for k in TABLES}


@pytest.mark.parametrize("iters", [1, 32, 300])
@pytest.mark.parametrize("name", list(CASES))
def test_twin_equals_jax(name, iters):
    """v, z, yl, done and it of the twin equal JAX's loop with
    ``torch.equal`` (sums in JAX's slot order, sum2 on the same side of
    eps_stop)."""
    structs, llrs, alpha, mu, max_iter, done, it = _case(name)
    start, fns = _jax_start(structs, llrs, alpha, mu)
    want = _jax_iterate(structs, fns, start, done, it, max_iter, iters)
    q, v, z, yl = (torch.from_numpy(x) for x in start)
    got = admm_iterate_ref(q, v, z, yl, torch.from_numpy(done),
                           torch.from_numpy(it), _tables(structs, CPU),
                           torch.from_numpy(alpha), torch.from_numpy(mu),
                           EPS, max_iter, iters)
    for key, g, w in zip(("v", "z", "yl", "done", "it"), got, want):
        assert torch.equal(g, torch.from_numpy(w)), key
    if name == "cut":
        assert int(got[4].max()) == min(iters, max_iter)
    if name == "done":
        assert torch.equal(got[4][::3], torch.full_like(got[4][::3], 7))
    if iters == 300 and name != "cut":   # both stops inside 300
        assert 0 < int(got[3].sum()) < got[3].numel()


@pytest.mark.parametrize("iters", [1, 32])
def test_twin_equals_jax_past_1024_slots(iters):
    """The star code (1,200 slots a variable) sums its windows' sums in
    windows again, as XLA does: the twin equals JAX's loop with
    ``torch.equal``."""
    structs, llrs, alpha, mu, max_iter, done, it = _case("star", GPU_CASES)
    assert structs[0].var_con.shape[1] == 1200
    start, fns = _jax_start(structs, llrs, alpha, mu)
    want = _jax_iterate(structs, fns, start, done, it, max_iter, iters)
    q, v, z, yl = (torch.from_numpy(x) for x in start)
    got = admm_iterate_ref(q, v, z, yl, torch.from_numpy(done),
                           torch.from_numpy(it), _tables(structs, CPU),
                           torch.from_numpy(alpha), torch.from_numpy(mu),
                           EPS, max_iter, iters)
    for key, g, w in zip(("v", "z", "yl", "done", "it"), got, want):
        assert torch.equal(g, torch.from_numpy(w)), key


@pytest.mark.parametrize("shape,kind", [
    ((16, 126, 24), "coef"), ((16, 126, 32), "coef"), ((16, 126, 33), "coef"),
    ((16, 126, 36), "coef"), ((16, 126, 47), "coef"), ((16, 126, 72), "coef"),
    ((16, 126, 100), "coef"), ((8, 1536), "square"), ((8, 2320), "square"),
    ((8, 4520), "square"), ((8, 5120), "square")])
def test_xla_sum_is_jax_sum(shape, kind):
    """``xla_sum`` equals a jitted ``jnp.sum`` over the last axis on the
    CPU bit for bit (as int32): products of coefficients in {-1, 0, 1}
    (QP-ADMM's slot sums), and rounded squares over rows as long as sum2's
    (two levels of windows past 1,024)."""
    rng = np.random.default_rng(sum(shape))
    if kind == "coef":
        a = rng.standard_normal(shape).astype(np.float32)
        b = rng.integers(-1, 2, shape).astype(np.float32)
        want = jax.jit(lambda x, y: jnp.sum(x * y, axis=-1))(a, b)
        got = xla_sum(torch.from_numpy(a) * torch.from_numpy(b))
    else:
        a = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
        want = jax.jit(lambda x: jnp.sum(x * x, axis=-1))(a)
        t = torch.from_numpy(a)
        got = xla_sum(t * t)
    assert torch.equal(got.view(torch.int32),
                       torch.from_numpy(np.array(want)).view(torch.int32))


def test_wrapper_runs_the_twin_on_the_cpu():
    """On a CPU tensor the wrapper is the twin (new tensors, no launch);
    another device raises."""
    structs, llrs, alpha, mu, max_iter, done, it = _case("H")
    start, _ = _jax_start(structs, llrs, alpha, mu)
    args = [torch.from_numpy(x) for x in start] + [
        torch.from_numpy(done), torch.from_numpy(it), _tables(structs, CPU),
        1.2, 0.55, EPS, max_iter, 40]
    before = admm_kernel.ITERATE_LAUNCHES
    got, want = admm_iterate(*args), admm_iterate_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert admm_kernel.ITERATE_LAUNCHES == before
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in args]
    with pytest.raises(ValueError, match="no implementation"):
        admm_iterate(*meta)


def test_sum2_is_each_pairs_last():
    """``sum2`` receives each pair's sum2 of its last iteration; pairs
    that ran none keep theirs."""
    structs, llrs, alpha, mu, max_iter, done, it = _case("done")
    start, _ = _jax_start(structs, llrs, alpha, mu)
    q, v, z, yl = (torch.from_numpy(x) for x in start)
    sum2 = torch.full(done.shape, -1.0)
    out = admm_iterate_ref(q, v, z, yl, torch.from_numpy(done),
                           torch.from_numpy(it), _tables(structs, CPU),
                           1.2, 0.55, EPS, max_iter, 300, sum2=sum2)
    ran = ~torch.from_numpy(done)
    assert bool((sum2[~ran] == -1.0).all())
    conv = ran & out[3] & (out[4] < max_iter)
    assert bool((sum2[conv] < EPS).all()) and bool(conv.any())
    assert bool((sum2[ran & ~out[3]] >= EPS).all())


def test_pack_tables_codes():
    """The compact copy of a code at caps: each constraint's codes name its
    variables' positions with the coefficient's sign and the zero row
    ``n_var`` for a padding slot; an entry outside the contract (a
    coefficient of 0.5, an index out of range, a real index with no
    coefficient) becomes ``CSR_BAD`` where it stands and nowhere else; and
    the padded slot tables are not returned."""
    s = ADMMStructure.from_h(read_pcm(os.path.join(DATA, "H.txt")),
                             n_var_cap=460, n_con_cap=1540, k_max_cap=21)
    t = {k: torch.from_numpy(getattr(s, k))[None] for k in TABLES}
    p = pack_tables(t)
    assert set(p) == set(t) | set(admm_kernel.PACKED)
    assert p["con_code4"].shape == (1, 1540, 4)
    assert p["con_code4"].dtype == torch.int16
    assert p["var_info"].dtype == torch.int64
    rank = torch.empty(460, dtype=torch.int64).scatter_(
        0, p["var_pos"][0].long(), torch.arange(460)).numpy()
    rows, neg = _decode_code(p["con_code4"][0, :, :3])
    want = np.where(s.con_coef != 0, rank[s.con_var.clip(0, 459)], 460)
    np.testing.assert_array_equal(rows.numpy(), want)
    np.testing.assert_array_equal(neg.numpy(), s.con_coef < 0)
    bad = {k: v.clone() for k, v in t.items()}
    bad["var_coef"][0, 3, 0] = 0.5
    bad["con_var"][0, 5, 1] = 460 + 7
    bad["con_coef"][0, 6, 2] = 0.0                  # real index, no coef
    p = pack_tables(bad)
    code = p["con_code4"][0, :, :3].long() & 0xffff
    assert (code == 0xffff).nonzero().tolist() == [[5, 1], [6, 2]]
    assert int((p["var_csr"] == admm_kernel.CSR_BAD).sum()) == 1
    info = p["var_info"][0, int(rank[3])]
    assert int(p["var_csr"][0, int(info) & 0xffffffff]) == admm_kernel.CSR_BAD


@pytest.mark.parametrize("shape,tier", [
    ((700, 2320, 24), (256, 2)), ((1260, 4520, 72), (512, 2)),
    ((1280, 5120, 32), (512, 2)), ((2048, 6144, 72), (512, 1)),
    ((3000, 6000, 8), (512, 1)), ((3200, 10240, 12), (512, 1)),
    ((9000, 10000, 24), (512, 1)), ((9000, 11000, 24), (512, 1)),
    ((700, 2320, 600), (512, 1)), ((30000, 32000, 8), None),
    ((40000, 10, 8), None), ((0, 10, 8), None), ((700, 2320, 40000), None)])
def test_plan(shape, tier):
    """A tier by the tables' shape: optimalH two blocks of 256 threads and
    2 lanes a block per SM, H02 and the optimizer's caps 512 threads and 2
    lanes, up to 4,096 variables and 10,240 constraints 512 and 1, and the
    global tier (tables in device memory) any other shape whose v, t and b
    fit; the shared bytes are v and t of the lanes with their zero rows,
    b, the threads' parts of sum2 (32 rows of the warps' parts, each
    padded by 4), the slot control and, but in the global tier, the
    compact tables, at most 227 KB; a shape past that, the int16 codes or
    32,767 slots a variable raises."""
    if tier is None:
        with pytest.raises(ValueError, match="do not fit"):
            admm_plan(*shape)
        return
    n_var, n_con, k = shape
    nq = -(-n_con // 4)
    plan = admm_plan(*shape)
    threads, lanes = tier
    assert (plan["threads"], plan["lanes"]) == tier
    assert plan["blocks"] == (2 if threads == 256 else 1)
    assert plan["rq"] * threads // lanes >= nq
    cap = min(k * -(-n_var // 32) * 32, 3 * n_con + 64 * k)
    assert plan["csr_cap"] == -(-cap // 8) * 8
    state = 4 * (-(-lanes * (n_var + 1) // 4) * 4 + 4 * lanes * (nq + 1)
                 + 4 * nq + threads + 128 + 16)
    if plan["global"]:
        assert plan["tier"] == 3 and plan["smem_bytes"] == state
        assert (n_var > 4096 or nq > 2560 or k > 511
                or state + 32 * nq + 4 * plan["csr_cap"] > 232448)
    else:
        assert plan["rv"] * threads >= n_var
        assert plan["smem_bytes"] == state + 32 * nq + 4 * plan["csr_cap"]
    assert plan["smem_bytes"] <= 232448 // plan["blocks"]


@pytest.mark.parametrize("k", [1, 12, 72, 511, 32767])
def test_plan_takes_every_shape_of_one_block_a_pair(k):
    """Every pair the one-block-per-pair design took (v, q, inv_coef, t, z
    and yl in shared memory: 4 (3 n_var + 3 n_con + 8) bytes of at most
    227 KB, indices below 32,767, any slot count an int16 holds) has a
    tier: the largest n_con for each n_var on a grid, and shapes near the
    origin."""
    shapes = [(nv, min(32766, (232448 // 4 - 8) // 3 - nv))
              for nv in range(1, 19369, 97)]
    shapes += [(nv, nc) for nv in range(1, 40) for nc in range(1, 40, 7)]
    for n_var, n_con in shapes:
        assert 4 * (3 * n_var + 3 * n_con + 8) <= 232448
        plan = admm_plan(n_var, n_con, k)
        assert plan["smem_bytes"] <= 232448


def _structs(name):
    """The structures of a compact-table case: one code at its exact
    size or at caps (``name@caps``), or the state file's chain incumbents
    at their bucketed caps."""
    if name == "incumbents":
        hs = _incumbents()
        caps = _caps_for(hs)
    else:
        mat, at = name.split("@") if "@" in name else (name, "")
        hs = [_wide() if mat == "wide" else _star() if mat == "star" else
              read_pcm(os.path.join(DATA, f"{mat}.txt"))]
        caps = CAPS[at] if at else {}
    return hs, [ADMMStructure.from_h(h, **caps) for h in hs]


def _decode_code(c):
    """(row, negative) of 16-bit constraint codes."""
    c = c.long() & 0xffff
    return c & 0x7fff, (c & admm_kernel.SIGN) != 0


def _slots(items, window=False):
    """The (constraint row, negative) of each slot that 32-bit variable
    items cover, in slot order: a quad item four rows 4g ... 4g + 3. With
    ``window``, each slot's window instead: the items marked ``WIN`` so far
    (a slot's window counts from the first one the variable has)."""
    out, w = [], 0
    for c in (int(x) & 0xffffffff for x in items):
        w += bool(c & admm_kernel.WIN)
        if c & admm_kernel.RUN:
            g, signs = c & 0xffff, (c >> 16) & 0xf
            out += [w if window else (4 * g + j, bool((signs >> j) & 1))
                    for j in range(4)]
        else:
            out.append(w if window else (c & 0xffff, bool((c >> 16) & 1)))
    return out


@pytest.mark.parametrize("name", ["H", "optimalH", "H02", "optimalH@caps",
                                  "incumbents", "wide", "optimalH@k36"])
def test_pack_tables_compact(name):
    """The compact copy names the padded tables' slots: the real counts are
    the cascade's, ``var_pos`` is a permutation with the real variables
    first by degree, each real variable's CSR slots (in its group of 32,
    slot-major) decode to its slots in order, the constraints' codes to
    theirs over the positions, and ``var_info`` holds each position's
    offset, length, trailing-padding and variable-0 bits. Past 32 slots
    (H02's 72, optimalH at caps of 36) each slot lies in its window of
    XLA's, no run crosses a window's boundary, and ``WIN`` marks exactly
    the items that start a window; at 32 or fewer no item has ``WIN``."""
    hs, structs = _structs(name)
    p = pack_tables(_tables(structs, CPU))
    n_var, k = structs[0].var_con.shape
    n_con = structs[0].con_var.shape[0]
    assert p["var_csr"].shape == (len(hs), admm_plan(n_var, n_con,
                                                      k)["csr_cap"])
    assert p["con_code4"].shape == (len(hs), 4 * -(-n_con // 4), 4)
    nq = -(-n_con // 4)
    for c, (h, s) in enumerate(zip(hs, structs)):
        nv_real, nc_real = p["real"][c].tolist()
        assert (nv_real, nc_real) == _structure_caps(h)[:2]
        order = p["var_pos"][c].long()
        assert sorted(order.tolist()) == list(range(n_var))
        assert order[nv_real:].tolist() == list(range(nv_real, n_var))
        real = (s.var_coef != 0).sum(axis=1)
        degs = real[order[:nv_real].numpy()]
        assert (np.diff(degs) <= 0).all()
        rank = torch.empty_like(order).scatter_(0, order,
                                                torch.arange(n_var))
        info = p["var_info"][c]
        base, count = info & 0xffffffff, (info >> 32) & 0xffff
        csr = p["var_csr"][c]
        if k <= 32:
            assert not bool((csr & admm_kernel.WIN).any())
        front = (-(-k // 32) * 32 - k) // 2
        runs = 0
        for pos in range(nv_real):
            i = int(order[pos])
            n_slots = max(int(real[i]), 1)
            assert int((info[pos] >> 48) & 1) == (n_slots < k)
            assert int((info[pos] >> 49) & 1) == (i == 0)
            assert int(base[pos]) % 32 == pos % 32
            items = csr[base[pos] + 32 * torch.arange(int(count[pos]))]
            runs += int((items < 0).sum())
            got = _slots(items)
            want = [(int(r) if f else 4 * nq, bool(f < 0)) for r, f in
                    zip(s.var_con[i, :n_slots], s.var_coef[i, :n_slots])]
            assert got == want, (pos, i)
            if k > 32:
                assert _slots(items, window=True) == [
                    (j + front) // 32 for j in range(n_slots)], (pos, i)
        if name in ("optimalH", "optimalH@caps", "incumbents"):
            assert 4 * runs == int(real.sum())    # every slot in a quad
        rows, neg = _decode_code(p["con_code4"][c, :n_con, :3])
        pad = s.con_coef == 0
        want = np.where(pad, n_var, rank[np.minimum(s.con_var, n_var - 1)])
        np.testing.assert_array_equal(rows.numpy(), want)
        np.testing.assert_array_equal(neg.numpy(), s.con_coef < 0)
        flag = p["con_code4"][c, ::4, 3].numpy()
        quads = np.zeros((4 * nq, 3), np.int64)
        quads[:n_con] = want
        same = (quads.reshape(nq, 4, 3) == quads.reshape(nq, 4, 3)[:, :1]
                ).all(axis=(1, 2)) & (np.arange(nq) < n_con // 4)
        negs = (s.con_coef < 0)[:4 * (n_con // 4)].reshape(-1, 4, 3)
        cascade = np.zeros(nq, bool)
        cascade[:n_con // 4] = (negs == (np.arange(4)[:, None] != np.arange(3))
                                & (np.arange(4)[:, None] < 3)).all(axis=(1, 2))
        np.testing.assert_array_equal(flag, same + 2 * (same & cascade))
        if name in ("optimalH", "optimalH@caps", "incumbents"):
            assert (flag[:nc_real // 4] == 3).all()  # every real quad
            assert (flag[-(-nc_real // 4):] == 1).all()   # padding quads
        assert not p["con_code4"][c, n_con:].any()
        assert not p["con_code4"][c].view(nq, 4, 4)[:, 1:, 3].any()


def test_pack_tables_flags_bad_and_overflow():
    """A code outside the contract reaches the compact copy as
    ``CSR_BAD``, and so does a CSR that outgrows its capacity (tables
    whose variables name more slots than the constraints hold)."""
    s = ADMMStructure.from_h(read_pcm(os.path.join(DATA, "H.txt")))
    t = {k: torch.from_numpy(getattr(s, k))[None] for k in TABLES}
    t["var_coef"][0, 3, 0] = 0.5
    t["con_coef"][0, 6, 2] = 0.0
    p = pack_tables(t)
    assert int((p["var_csr"] == admm_kernel.CSR_BAD).sum()) == 1
    assert int((p["con_code4"] == admm_kernel.CSR_BAD).sum()) == 1
    n_var, n_con, k = 256, 2, 8
    dense = {"var_con": torch.zeros((1, n_var, k), dtype=torch.int32),
             "var_coef": torch.ones((1, n_var, k)),
             "con_var": torch.zeros((1, n_con, 3), dtype=torch.int32),
             "con_coef": torch.ones((1, n_con, 3)),
             "b": torch.zeros((1, n_con)), "e": torch.ones((1, n_var))}
    p = pack_tables(dense)
    assert p["var_csr"].shape[1] < n_var * k
    assert int(p["var_csr"][0, 0]) == admm_kernel.CSR_BAD


def _emulate(tables, q, z, yl, alpha, mu, iters):
    """The kernel's data flow on the CPU from the compact copy alone, with
    no pair stopping: the real positions' slot sums in CSR order (past 32
    slots a variable, each window from +0 as the items' ``WIN`` marks
    start them, and every 32 windows, counted from the front padding of
    XLA's second level, a sum of their own), the zero rows, the real
    constraint rows only, and each padding variable's v in closed form
    from the last t[0] * 0. Returns (v, z, yl)."""
    p_count, n_var = tables["var_pos"].shape
    n_con, k = tables["b"].shape[1], tables["var_con"].shape[2]
    bsz = q.shape[0]
    a, m = (lane_param(x, bsz, CPU) for x in (alpha, mu))
    half = a / 2.0
    outs = []
    for c in range(p_count):
        nv_real, nc_real = tables["real"][c].tolist()
        order = tables["var_pos"][c].long()
        info = tables["var_info"][c]
        base, count = info & 0xffffffff, (info >> 32) & 0xffff
        items = [tables["var_csr"][c][base[pos] + 32 * torch.arange(
            int(count[pos]))] for pos in range(nv_real)]
        per_pos = [_slots(i) for i in items]
        width = max(len(x) for x in per_pos)
        live = torch.tensor([[j < len(x) for j in range(width)]
                             for x in per_pos])
        rows = torch.tensor([[x[min(j, len(x) - 1)][0] for j in range(width)]
                             for x in per_pos])
        neg = torch.tensor([[x[min(j, len(x) - 1)][1] for j in range(width)]
                            for x in per_pos])
        rows = torch.where(rows == 4 * -(-n_con // 4), n_con, rows)
        wid = torch.tensor([[x[min(j, len(x) - 1)] for j in range(width)]
                            for x in (_slots(i, window=True)
                                      for i in items)])
        windows = -(-k // 32)
        front2 = (-(-windows // 32) * 32 - windows) // 2
        crow, cneg = _decode_code(tables["con_code4"][c, :n_con, :3])
        b, e = tables["b"][c], tables["e"][c]
        qc = q[:, c * n_var:(c + 1) * n_var]
        zc = z[:, c * n_con:(c + 1) * n_con].clone()
        yc = yl[:, c * n_con:(c + 1) * n_con].clone()

        def inv_of(i):
            den = m * e[i] - a
            return -1.0 / torch.where(den == 0, torch.ones(()), den)
        qh = qc[:, order[:nv_real]] + half
        inv = inv_of(order[:nv_real])
        t = torch.zeros((bsz, n_con + 1))
        t[:, :nc_real] = yc[:, :nc_real] + m * (zc[:, :nc_real]
                                                - b[:nc_real])
        t[:, n_con] = t[:, 0] * 0.0
        trail = ((info[:nv_real] >> 48) & 1).bool()
        var0 = int(((info >> 49) & 1).nonzero()[0])
        sv = torch.zeros((bsz, n_var + 1))
        for _ in range(iters):
            tz = t[:, n_con].clone()
            g = t[:, rows]
            g = torch.where(neg, -g, g)
            if k <= 32:
                acc = g[:, :, 0]
                for s_ in range(1, width):
                    acc = torch.where(live[:, s_], acc + g[:, :, s_], acc)
            else:    # windows from +0, and windows of windows past 32
                acc, lvl2, win = (torch.zeros_like(g[:, :, 0])
                                  for _ in range(3))
                for s_ in range(width):
                    new = live[:, s_] & (wid[:, s_] > wid[:, s_ - 1]) \
                        if s_ else torch.zeros_like(live[:, 0])
                    lvl2 = torch.where(new, lvl2 + win, lvl2)
                    win = torch.where(new, 0.0, win)
                    top = new & ((wid[:, s_] + front2) % 32 == 0)
                    acc = torch.where(top, acc + lvl2, acc)
                    lvl2 = torch.where(top, 0.0, lvl2)
                    win = torch.where(live[:, s_], win + g[:, :, s_], win)
                acc = acc + (lvl2 + win)
            acc = torch.where(trail, acc + tz[:, None], acc)
            sv[:, :nv_real] = ((qh + acc) * inv).clamp(0.0, 1.0)
            sv[:, n_var] = sv[:, var0] * 0.0
            x = sv[:, crow[:nc_real]]
            x = torch.where(cneg[:nc_real], -x, x)
            r = b[:nc_real] - ((x[:, :, 0] + x[:, :, 1]) + x[:, :, 2])
            yo = yc[:, :nc_real]
            zn = (r - yo).clamp_min(0.0)
            yn = (yo - r).clamp_min(0.0)
            zc[:, :nc_real], yc[:, :nc_real] = zn, yn
            t[:, :nc_real] = yn + m * (zn - b[:nc_real])
            t[:, n_con] = t[:, 0] * 0.0
        v = torch.empty((bsz, n_var))
        v[:, order[:nv_real]] = sv[:, :nv_real]
        pad = order[nv_real:]
        acc = (torch.zeros_like(tz[:, None]) if k > 32 else
               tz[:, None] + tz[:, None] if k > 1 else tz[:, None])
        v[:, pad] = ((qc[:, pad] + half + acc) * inv_of(pad)).clamp(0.0, 1.0)
        outs.append((v, zc, yc))
    return tuple(torch.cat([o[j] for o in outs], dim=1) for j in range(3))


@pytest.mark.parametrize("iters", [1, 40])
@pytest.mark.parametrize("name", ["H", "params", "population", "incumbents",
                                  "wide", "h02_feasible", "optimalH@k33",
                                  "optimalH@k36", "star"])
def test_compact_tables_drive_the_twin(name, iters):
    """The kernel's data flow, emulated on the CPU from the compact copy
    alone (padding rows skipped, padding variables in closed form, windows
    past 32 slots), equals the twin in v, z and yl with ``torch.equal``
    after 1 and 40 iterations with no pair stopping: the packing and the
    padding argument hold."""
    if name in ("incumbents", "wide", "star"):
        hs, structs = _structs(name)
        n = hs[0].shape[1]
        llrs = np.stack([_llrs(h, 8, -3.0, 40 + i) for i, h in
                         enumerate(hs)])
        alpha, mu = np.float32(1.95), np.float32(0.5)
    else:
        structs, llrs, alpha, mu = _case(name)[:4]
        n = structs[0].n
    tables = pack_tables(_tables(structs, CPU))
    p_count, bsz = llrs.shape[:2]
    n_var, n_con = structs[0].n_var, structs[0].n_con
    q = torch.from_numpy(llrs).transpose(0, 1)
    q = torch.cat([q, q.new_zeros((bsz, p_count, n_var - n))],
                  dim=2).reshape(bsz, -1)
    z = q.new_zeros((bsz, p_count * n_con))
    a, m = torch.as_tensor(alpha), torch.as_tensor(mu)
    want = admm_iterate_ref(q, (q > 0).float(), z, z.clone(),
                            torch.zeros((bsz, p_count), dtype=torch.bool),
                            torch.zeros((bsz, p_count), dtype=torch.int32),
                            tables, a, m, float("-inf"), 2 ** 31 - 1,
                            iters)
    got = _emulate(tables, q, z, z.clone(), a, m, iters)
    for key, g, w in zip(("v", "z", "yl"), got, want):
        assert torch.equal(g, w), key


def test_decoder_packs_only_on_the_card(small_h):
    """The decoder's population of one is its buffers' views on the CPU;
    the packed copy is made only where the kernel runs."""
    dec = QPADMMDecoder(small_h, device=CPU)
    pop = dec._population()
    assert set(pop) == set(TABLES) and pop is dec._population()
    assert all(pop[k].shape[0] == 1 for k in TABLES)


# ---------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _held(start, got, want, tables, alpha, mu):
    """Kernel (``got``) against twin (``want``) from ``start``: the pairs
    whose stop differs must be sum2 ties; the rest equal in v, z, yl, done
    and it. Returns the ties."""
    ties, others = stop_ties(start, got, want, tables, alpha, mu, EPS,
                             admm_iterate, admm_iterate_ref)
    assert not others, others
    bsz, p_count = start[4].shape
    keep = torch.ones((bsz, p_count), dtype=torch.bool, device=start[0].device)
    for lane, cand, *_ in ties:
        keep[lane, cand] = False
    for key, g, w in zip(("v", "z", "yl", "done", "it"), got, want):
        g, w = g.view(bsz, p_count, -1)[keep], w.view(bsz, p_count, -1)[keep]
        assert _same(g, w), key
    return ties


def _same(a, b):
    """``torch.equal``, with NaN equal to NaN in the same places (a lane
    whose q is NaN carries NaN in its state on both sides)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _card_start(name, cuda):
    structs, llrs, alpha, mu, max_iter, done, it = _case(name, GPU_CASES)
    p_count, bsz = llrs.shape[:2]
    nv = structs[0].n_var
    q = torch.from_numpy(llrs).to(cuda).transpose(0, 1)
    q = torch.cat([q, q.new_zeros((bsz, p_count, nv - structs[0].n))],
                  dim=2).reshape(bsz, -1)
    nc = structs[0].n_con
    z, yl = (q.new_zeros((bsz, p_count * nc)) for _ in range(2))
    if name == "premise":       # off the padding's fixed point at entry
        z.view(bsz, p_count, nc)[PREMISE["pad_z"], :, -1] = 0.5
        yl.view(bsz, p_count, nc)[PREMISE["pad_yl"], :, -1] = float("nan")
        yl.view(bsz, p_count, nc)[PREMISE["neg_yl"], :, -1] = -0.0
    start = (q, (q > 0).float(), z, yl, torch.from_numpy(done).to(cuda),
             torch.from_numpy(it).to(cuda))
    return (start, _tables(structs, cuda), torch.from_numpy(alpha).to(cuda),
            torch.from_numpy(mu).to(cuda), max_iter)


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [1, 32, 512])
@pytest.mark.parametrize("name", list(GPU_CASES))
def test_kernel_equals_twin(name, iters, cuda):
    start, tables, alpha, mu, max_iter = _card_start(name, cuda)
    before = admm_kernel.ITERATE_LAUNCHES
    got = admm_iterate(*(t.clone() for t in start), tables, alpha, mu, EPS,
                       max_iter, iters)
    torch.cuda.synchronize()
    assert admm_kernel.ITERATE_LAUNCHES == before + 1
    want = admm_iterate_ref(*start, tables, alpha, mu, EPS, max_iter, iters)
    _held(start, got, want, tables, alpha, mu)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GPU_CASES))
def test_batched_decode_equals_twin(name, cuda, monkeypatch):
    """``decode_qp_admm_population`` on the card (one launch) against the
    same decode through the twin: bits, success and iterations equal but
    on ties, which the state-level rerun confirms."""
    start, tables, alpha, mu, max_iter = _card_start(name, cuda)
    structs, llrs = _case(name, GPU_CASES)[:2]
    n = structs[0].n
    max_iter = min(max_iter, 3000)
    llrs = torch.from_numpy(llrs).to(cuda)
    fresh = start[:4] + (torch.zeros_like(start[4]),
                         torch.zeros_like(start[5]))
    before = admm_kernel.ITERATE_LAUNCHES
    got = admm.decode_qp_admm_population(tables, n, llrs, alpha, mu,
                                         max_iter, EPS)
    assert admm_kernel.ITERATE_LAUNCHES == before + 1
    monkeypatch.setattr(admm, "admm_iterate", admm_iterate_ref)
    want = admm.decode_qp_admm_population(tables, n, llrs, alpha, mu,
                                          max_iter, EPS)
    ties = []
    if not torch.equal(got.iterations, want.iterations):
        k = admm_iterate(*(t.clone() for t in fresh), tables, alpha, mu,
                         EPS, max_iter, max_iter)
        w = admm_iterate_ref(*fresh, tables, alpha, mu, EPS, max_iter,
                             max_iter)
        ties = _held(fresh, k, w, tables, alpha, mu)
    keep = torch.ones_like(got.success)
    for lane, cand, *_ in ties:
        keep[cand, lane] = False
    assert torch.equal(got.success, want.success)
    assert torch.equal(got.bits[keep], want.bits[keep])
    assert torch.equal(got.iterations[keep], want.iterations[keep])


@pytest.mark.gpu
def test_premise_case_leaves_the_fixed_point(cuda):
    """The premise case does what it is for: its NaN-q lane carries NaN
    into every candidate's padding z, its NaN-padding lane keeps NaN there
    and never stops (sum2 is NaN), and its +inf lane stays finite; all as
    the twin gives them."""
    start, tables, alpha, mu, max_iter = _card_start("premise", cuda)
    got = admm_iterate(*(t.clone() for t in start), tables, alpha, mu, EPS,
                       max_iter, 512)
    want = admm_iterate_ref(*start, tables, alpha, mu, EPS, max_iter, 512)
    _held(start, got, want, tables, alpha, mu)
    bsz, p_count = start[4].shape
    nc = tables["b"].shape[1]
    z = got[1].view(bsz, p_count, nc)[:, :, -1]
    yl = got[2].view(bsz, p_count, nc)[:, :, -1]
    assert bool(torch.isnan(z[PREMISE["nan_q"]]).all())
    assert bool(torch.isnan(yl[PREMISE["pad_yl"]]).all())
    assert not bool(got[3][PREMISE["pad_yl"]].any())
    assert not bool(torch.isnan(got[0][PREMISE["inf_q"]]).any())


@pytest.mark.gpu
def test_sum2_is_the_pairs_alone(cuda):
    """A pair's sum2 (and state) is the same whatever the batch, the
    candidate count, the iterations a launch and its block-mates: the
    population of two over 24 iterations in one launch, in three launches
    of 8, its lanes 3-8 alone, its lanes reversed, and each candidate
    alone."""
    start, tables, alpha, mu, _ = _card_start("population", cuda)
    bsz, p_count = start[4].shape
    never = (float("-inf"), 2 ** 31 - 1)
    start = start[:4] + (torch.zeros_like(start[4]), start[5])

    def run(state, tabs, a, m, launches):
        state = [t.clone() for t in state]
        out = torch.full(tuple(state[4].shape), float("nan"),
                         device=cuda)
        for n in launches:
            state = [state[0], *admm_iterate(*state, tabs, a, m, *never, n,
                                             sum2=out)]
        return out, state

    ref, ref_state = run(start, tables, alpha, mu, [24])
    split, split_state = run(start, tables, alpha, mu, [8, 8, 8])
    assert torch.equal(ref, split)
    assert all(_same(a, b) for a, b in zip(ref_state, split_state))
    lanes = slice(3, 9)
    part, _ = run([t[lanes].contiguous() for t in start], tables,
                  alpha[lanes], mu[lanes], [24])
    assert torch.equal(part, ref[lanes])
    flip = torch.arange(bsz - 1, -1, -1, device=cuda)
    rev, _ = run([t[flip].contiguous() for t in start], tables, alpha[flip],
                 mu[flip], [24])
    assert torch.equal(rev[flip], ref)
    nv, nc = tables["e"].shape[1], tables["b"].shape[1]
    for c in range(p_count):
        one = {k: t[c:c + 1] for k, t in tables.items()}
        rows = [start[0].view(bsz, p_count, nv)[:, c],
                start[1].view(bsz, p_count, nv)[:, c],
                start[2].view(bsz, p_count, nc)[:, c],
                start[3].view(bsz, p_count, nc)[:, c],
                start[4][:, c:c + 1], start[5][:, c:c + 1]]
        alone, _ = run([t.contiguous() for t in rows], one, alpha, mu, [24])
        assert torch.equal(alone[:, 0], ref[:, c])


@pytest.mark.gpu
def test_sum2_is_the_same_at_any_caps(cuda):
    """One code's pairs at their exact size (the first tier), padded to
    the optimizer's caps (the second), to caps of the third tier (at 32
    slots a variable: past 32 the slot sums follow XLA's windows over the
    tables' width, as JAX's do) and of the global tier: sum2 after 1 and
    after 24 iterations, and the state of the real rows, are the same bits
    in all four (sum2's butterfly over the quads does not see the tier,
    and padding adds +0)."""
    h = read_pcm(os.path.join(DATA, "optimalH.txt"))
    n_var, n_con = _structure_caps(h)[:2]
    llrs = torch.from_numpy(_llrs(h, 16, -3.0, 40)).to(cuda)
    never = (float("-inf"), 2 ** 31 - 1)
    tiers, runs = [], []
    for caps in ({}, CAPS["caps"], dict(CAPS["tier2"], k_max_cap=32),
                 CAPS["global"]):
        s = ADMMStructure.from_h(h, **caps)
        tiers.append(admm_plan(s.n_var, s.n_con,
                               s.var_con.shape[1])["tier"])
        q = llrs.new_zeros((16, s.n_var))
        q[:, :s.n] = llrs
        z = q.new_zeros((16, s.n_con))
        state = [q, (q > 0).float(), z, z.clone(),
                 torch.zeros((16, 1), dtype=torch.bool, device=cuda),
                 torch.zeros((16, 1), dtype=torch.int32, device=cuda)]
        sums = []
        for n in (1, 23):
            out = torch.full((16, 1), float("nan"), device=cuda)
            state = [state[0], *admm_iterate(*state, _tables([s], cuda), 1.2,
                                             0.55, *never, n, sum2=out)]
            sums.append(out)
        runs.append((sums, state))
    assert tiers == [0, 1, 2, 3]
    ref, ref_state = runs[0]
    for sums, state in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(sums, ref))
        for a, b, n in zip(state[1:4], ref_state[1:4],
                           (n_var, n_con, n_con)):
            assert torch.equal(a[:, :n], b)
        assert torch.equal(state[4], ref_state[4])
        assert torch.equal(state[5], ref_state[5])
        for pad in state[2:4]:              # padding z and yl stay +0
            assert not bool(pad[:, n_con:].any())
