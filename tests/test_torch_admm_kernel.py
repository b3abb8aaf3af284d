"""QP-ADMM's iteration kernel (``csrc/admm_iterate.cu``) and its plain twin
(``ops/admm_ref.py``) in the PyTorch port.

On the CPU: the twin ``admm_iterate_ref`` equals the JAX package's
iteration, ``_admm_setup(...)``'s ``iter_fn``
(``ldpc_tpu/decoders/admm.py:205-264``) looped as JAX's stream body loops
it (``:351-356``), with ``torch.equal`` in v, z, yl, done and the
iteration counts after 1, 32 and 300 iterations, on numpy inputs from a
seed: ``data/H.txt`` and optimalH at 16 lanes, ``max_iter`` cut in the
middle of a chunk, lanes already done at entry, per-lane (alpha, mu) and a
population of two candidates (optimalH and H05) padded to shared caps.
The wrapper runs the twin on a CPU tensor; the packed tables and the launch
plan are checked here too.

On the card (marked ``gpu``; ``python -m pytest
tests/test_torch_admm_kernel.py -m gpu --noconftest``): the kernel against
the twin on the same cases plus H02 at 64 lanes, after 1, 32 and 512
iterations and for whole batched decodes. v, z, yl and the counts must be
equal on every pair whose stop agrees; a pair whose stop differs passes
only as a tie: both sum2 values at the earlier stop on either side of
eps_stop within n_con * 2**-23 * sum2 (the kernel sums sum2 in its own
order), after reruns that reach equal states.
"""
import os

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.channel.awgn import llr_variance
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders import admm
from ldpc_tpu_torch.decoders.admm import (TABLES, ADMMStructure,
                                          QPADMMDecoder, _structure_caps)
from ldpc_tpu_torch.ops import admm_kernel
from ldpc_tpu_torch.ops.admm_kernel import (admm_iterate, admm_plan,
                                            pack_tables)
from ldpc_tpu_torch.ops.admm_ref import admm_iterate_ref, stop_ties

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
}
GPU_CASES = dict(CASES, H02=(("H02",), 64, -3.0, 1.2, 0.55, 10000, False,
                             False))
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
    hs = [read_pcm(os.path.join(DATA, f"{m}.txt")) for m in mats]
    caps = {}
    if len(hs) > 1:
        need = np.max([_structure_caps(h) for h in hs], axis=0)
        caps = dict(n_var_cap=int(need[0]) + 9, n_con_cap=int(need[1]) + 17,
                    k_max_cap=int(need[2]) + 2)
    structs = [ADMMStructure.from_h(h, **caps) for h in hs]
    llrs = np.stack([_llrs(h, lanes, snr, 40 + i) for i, h in enumerate(hs)])
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
    """+-(index + 1) by coefficient sign, 0 on padding, BAD on anything
    else; slot-major; each variable's slots up to its last real one."""
    s = ADMMStructure.from_h(read_pcm(os.path.join(DATA, "H.txt")),
                             n_var_cap=460, n_con_cap=1540, k_max_cap=21)
    t = {k: torch.from_numpy(getattr(s, k))[None] for k in TABLES}
    p = pack_tables(t)
    assert p["var_code"].shape == (1, 21, 460)
    assert p["con_code"].shape == (1, 3, 1540)
    assert p["var_code"].dtype == torch.int16
    idx = np.where(s.var_coef != 0, s.var_con + 1, 0) * np.sign(s.var_coef)
    np.testing.assert_array_equal(p["var_code"][0].numpy(), idx.T)
    idx = np.where(s.con_coef != 0, s.con_var + 1, 0) * np.sign(s.con_coef)
    np.testing.assert_array_equal(p["con_code"][0].numpy(), idx.T)
    real = (s.var_coef != 0).sum(axis=1)
    np.testing.assert_array_equal(p["var_len"][0].numpy(),
                                  np.maximum(real, 1))
    assert int(p["var_len"][0, -1]) == 1            # a phantom variable
    bad = {k: v.clone() for k, v in t.items()}
    bad["var_coef"][0, 3, 0] = 0.5
    bad["con_var"][0, 5, 1] = 460 + 7
    bad["con_coef"][0, 6, 2] = 0.0                  # real index, no coef
    p = pack_tables(bad)
    assert int(p["var_code"][0, 0, 3]) == admm_kernel.BAD
    assert int(p["con_code"][0, 1, 5]) == admm_kernel.BAD
    assert int(p["con_code"][0, 2, 6]) == admm_kernel.BAD
    assert int((p["var_code"] == admm_kernel.BAD).sum()) == 1


@pytest.mark.parametrize("shape,fits", [
    ((700, 2320), True), ((1260, 4520), True), ((1280, 5120), True),
    ((9000, 10000), True), ((9000, 11000), False), ((40000, 10), False),
    ((0, 10), False)])
def test_plan(shape, fits):
    """One block per pair: optimalH, H02 and the optimizer's caps fit; a
    pair past 227 KB of shared memory or the int16 codes raises."""
    if fits:
        plan = admm_plan(*shape)
        assert plan["threads"] == 256
        assert plan["smem_bytes"] == 4 * (3 * sum(shape) + 8) <= 232448
    else:
        with pytest.raises(ValueError, match="does not fit"):
            admm_plan(*shape)


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
        g, w = g.view(bsz, p_count, -1), w.view(bsz, p_count, -1)
        assert torch.equal(g[keep], w[keep]), key
    return ties


def _card_start(name, cuda):
    structs, llrs, alpha, mu, max_iter, done, it = _case(name, GPU_CASES)
    p_count, bsz = llrs.shape[:2]
    nv = structs[0].n_var
    q = torch.from_numpy(llrs).to(cuda).transpose(0, 1)
    q = torch.cat([q, q.new_zeros((bsz, p_count, nv - structs[0].n))],
                  dim=2).reshape(bsz, -1)
    nc = structs[0].n_con
    start = (q, (q > 0).float(), q.new_zeros((bsz, p_count * nc)),
             q.new_zeros((bsz, p_count * nc)),
             torch.from_numpy(done).to(cuda), torch.from_numpy(it).to(cuda))
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
