"""Python wrapper of QP-ADMM's hand-written iteration kernel
(``csrc/admm_iterate.cu``).

It has no Pallas counterpart: in ``ldpc_tpu/decoders/admm.py`` XLA fuses the
iteration (``iter_fn``, ``:249-262``) inside the decode's ``while_loop``
(``:184-197``) and the stream's (``:351-365``). :func:`admm_iterate` picks by
the device of ``q``: a CPU tensor goes to the plain twin
:func:`.admm_ref.admm_iterate_ref`, a CUDA tensor to the kernel
(:func:`._launch.on_cpu`). On CUDA it checks the state (dtypes, shapes,
contiguity, device), takes the launch layout from
:func:`admm_plan` (a tier by the tables' shape, which raises for one
that fits no tier), packs the tables (:func:`pack_tables`, unless given
packed) and launches once (:func:`._launch.launch`) on the current stream
without synchronising:
every pair runs to its own stop or to ``iters`` inside the launch, and the
host reads nothing (the pairs' queue is a zeroed tensor of P counters).
The kernel updates v, z, yl, done and it in place and the wrapper returns
them; the twin returns new tensors. Callers use the returned state either
way.

``ITERATE_LAUNCHES`` counts the kernel's launches, so a run can show that
its main path went through it.
"""
from __future__ import annotations

import torch

from .admm_ref import (CHECK_EVERY, WINDOW, admm_iterate_ref, lane_param,
                        window_front)
from ._launch import counter, expect, launch, on_cpu

ITERATE_LAUNCHES = 0
_COUNT = counter(__name__, "ITERATE_LAUNCHES")
MAX_SMEM = 232448      # the H100's opt-in shared memory per block
MAX_INDEX = 32766      # an index + 1 must fit an int16 code
MAX_LEN = 511          # slots a variable in a register tier
MAX_SLOTS = 32767      # slots a variable in any tier
BAD = -32768           # the slot code of an entry outside the contract
CSR_BAD = -1           # the same in the compact copy (all ones)
SIGN = 0x8000          # a constraint code's sign bit: coefficient -1
RUN = 1 << 31          # a variable item that covers a quad of slots
WIN = 1 << 30          # a variable item that starts a window (k > 32)
LEN_SHIFT, TRAIL_BIT, VAR0_BIT = 32, 48, 49   # var_info's fields
# (threads and lanes per block, variable positions and constraint quads
# per thread, blocks per SM the registers are bounded for, tables left in
# device memory), as kTiers of the source
TIERS = ((256, 2, 3, 5, 2, False), (512, 2, 3, 5, 1, False),
         (512, 1, 8, 5, 1, False), (512, 1, 0, 16, 1, True))
PACKED = ("var_csr", "var_info", "var_pos", "con_code4", "real")

__all__ = ["ITERATE_LAUNCHES", "admm_iterate", "admm_occupancy", "admm_plan",
           "iteration_work", "pack_tables"]


def csr_capacity(n_var: int, n_con: int, k: int) -> int:
    """Items of a candidate's compact variable table (``var_csr``): at
    most one a slot, k a variable in groups of 32, and at most the real
    slots (three a constraint) plus what the degree-sorted groups leave
    empty. Both hold when every item is a single slot, so runs split at
    the windows' boundaries add nothing to it."""
    cap = min(k * (-(-n_var // 32) * 32), 3 * n_con + 64 * k)
    return -(-cap // 8) * 8


def _smem(threads: int, lanes: int, glob: bool, n_var: int, n_con: int,
          k: int) -> int:
    nq = -(-n_con // 4)
    state = 4 * (-(-lanes * (n_var + 1) // 4) * 4 + 4 * lanes * (nq + 1)
                 + 4 * nq + threads + 128 + 16)
    return state if glob else (state + 32 * nq
                               + 4 * csr_capacity(n_var, n_con, k))


def admm_plan(n_var: int, n_con: int, k: int) -> dict:
    """The kernel's launch layout for pairs of ``n_var`` variables,
    ``n_con`` constraints and ``k`` slots a variable (the tables' shape,
    caps included), as ``csrc/admm_iterate.cu`` computes it: the first tier
    of ``TIERS`` whose block fits in ``smem_bytes`` of at most 227 KB (v and
    t of the lanes, b, the threads' parts of sum2 and, but in the global
    tier, the compact tables) and whose rows cover the shape: a register
    tier's ``threads`` cover the variables with ``rv`` positions each and
    the constraints' quads with ``rq`` quads a thread of each of the
    ``lanes`` lanes, for up to ``MAX_LEN`` slots a variable; the global
    tier (``global``: the tables read from device memory, the state out of
    registers) takes any number of variables and up to ``rq`` quads a
    thread. ``blocks`` is the blocks per SM the registers are bounded for.
    Raises ``ValueError`` when no tier fits or an index or a slot count
    does not fit the codes."""
    nq = -(-n_con // 4)
    fits = (0 < n_var <= MAX_INDEX and 0 < n_con <= MAX_INDEX
            and 0 < k <= MAX_SLOTS)
    for tier, (threads, lanes, rv, rq, blocks, glob) in enumerate(TIERS):
        if not fits:
            break
        smem = _smem(threads, lanes, glob, n_var, n_con, k)
        rows = (nq <= rq * threads if glob else
                k <= MAX_LEN and n_var <= rv * threads
                and nq <= rq * threads // lanes)
        if rows and smem <= MAX_SMEM:
            return {"threads": threads, "smem_bytes": smem, "lanes": lanes,
                    "tier": tier, "rv": rv, "rq": rq, "blocks": blocks,
                    "global": glob,
                    "csr_cap": csr_capacity(n_var, n_con, k)}
    raise ValueError(f"admm_plan: pairs of {n_var} variables, {n_con} "
                     f"constraints and {k} slots a variable do not fit the "
                     f"kernel ({MAX_SMEM} shared bytes a block for v, t "
                     f"and b; indices below {MAX_INDEX}, slots up to "
                     f"{MAX_SLOTS})")


def admm_occupancy(n_var: int, n_con: int, k: int) -> dict:
    """What the current CUDA device makes of :func:`admm_plan`'s tier
    (``ldpc_admm_iterate_occupancy``): blocks per SM, SMs, registers and
    local (spilled) bytes a thread. Builds the kernels; needs a card."""
    import ctypes

    from . import _build
    out = (ctypes.c_int * 4)()
    code = _build.load().ldpc_admm_iterate_occupancy(n_var, n_con, k, out)
    if code != 0:
        raise RuntimeError(f"admm_occupancy: CUDA error {code}")
    return dict(zip(("blocks_per_sm", "sms", "registers", "local_bytes"),
                    out))


def iteration_work(tables: dict, lanes: int, iters: int) -> tuple:
    """(operations, bytes): the work of one iteration of ``lanes`` lanes on
    each candidate of the packed ``tables``, counted on the real rows (not
    the caps): the float32 operations (each real slot's add, each
    variable's five other operations, each constraint's thirteen) and the
    bytes of one ``iters``-iteration launch over its iterations (q, v, z,
    yl read, v, z, yl written, the compact tables read once)."""
    ops = nbytes = 0
    real = tables["real"].tolist()
    slots = (tables["var_coef"] != 0).sum(dim=(1, 2)).tolist()
    items = ((tables["var_info"] >> 32) & 0xffff).sum(dim=1).tolist()
    for (nv, nc), n_slots, n_items in zip(real, slots, items):
        ops += lanes * (n_slots + 5 * nv + 13 * nc)
        nbytes += (4 * lanes * (3 * nv + 4 * nc)
                   + 4 * n_items + 20 * nv + 8 * 4 * -(-nc // 4) + 4 * nc)
    return ops, nbytes / iters


def _codes(idx: torch.Tensor, coef: torch.Tensor, pad: int) -> torch.Tensor:
    """int16 codes of a table's slots: +(index + 1) for coefficient +1,
    -(index + 1) for -1, 0 for padding (index ``pad``, coefficient 0),
    ``BAD`` for anything else."""
    idx = idx.to(torch.int32)
    real = (idx >= 0) & (idx < pad)
    code = torch.full_like(idx, BAD)
    code = torch.where(real & (coef == 1), idx + 1, code)
    code = torch.where(real & (coef == -1), -(idx + 1), code)
    code = torch.where((idx == pad) & (coef == 0), 0, code)
    return code.to(torch.int16)


def _int(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Signed ``bits``-bit integers of bit patterns held as int64 values in
    [-1, 2 ** bits)."""
    dtype = torch.int16 if bits == 16 else torch.int32
    return torch.where(x >= 1 << (bits - 1), x - (1 << bits), x).to(dtype)


def _last(flags: torch.Tensor) -> torch.Tensor:
    """(P,) one past the last True of (P, n) ``flags`` (0 for none)."""
    n = flags.shape[1]
    pos = torch.arange(1, n + 1, dtype=torch.int64, device=flags.device)
    return (flags.to(torch.int64) * pos).amax(dim=1)


def pack_tables(tables: dict) -> dict:
    """``tables`` (as :func:`admm_iterate`'s) with the kernel's packed copy
    added. Plain tensor ops on the tables' device; the host reads nothing.

    From the tables' slot codes (:func:`_codes`: +(index + 1) for
    coefficient +1, -(index + 1) for -1, 0 for padding, ``BAD`` for
    anything else) and each variable's ``var_len``, its slots up to its
    last real one (at least 1), the compact copy the kernel reads:

    * ``real`` (P, 2) int32: the real variables and constraints. The
      trailing rows whose codes are all 0 (and, for a constraint, whose b
      is +0) and to which no real row refers are padding; row 0 is always
      real;
    * ``var_pos`` (P, n_var) int32: the order in which the threads own the
      variables, a permutation: the real ones by ``var_len`` descending
      (ties by index), then the padding ones in order;
    * ``var_csr`` (P, ``csr_capacity``) int32: each real variable's first
      ``var_len`` slots as 32-bit items in slot order: four slots that
      name the constraints 4g ... 4g + 3 in turn are one item, ``RUN`` | g
      | their four signs << 16; any other slot is one item, its
      constraint | sign << 16, a padding slot the zero row 4 ceil(n_con /
      4); ``CSR_BAD`` for a ``BAD`` code. Past 32 slots a variable (k >
      32) the slots fall in XLA's windows of 32 (:func:`.admm_ref.xla_sum`:
      ``window_front(k)`` padding slots in front): no run crosses a
      window's boundary (such four slots are four items), and the item
      that starts a window but the first carries ``WIN``. Laid out in
      groups of 32 positions, item-major within a group, each group as
      long as its longest variable; an overflow writes ``CSR_BAD``;
    * ``var_info`` (P, n_var) int64 by position: the offset of its item 0
      | its items << 32 | (``var_len`` < k) << 48 | (it is variable 0) <<
      49;
    * ``con_code4`` (P, 4 ceil(n_con / 4), 4) int16: each constraint's
      three codes over the variables' positions (| SIGN for -1, the zero
      row ``n_var`` for padding, ``CSR_BAD`` for ``BAD``), and in the
      fourth column of row 4q a flag: 1 when the quad's four rows name the
      same three rows slot by slot, + 2 when their signs are also the
      cascade's (-1 in every slot of row i < 3 but slot i, none in row
      3); rows past n_con are 0.

    The kernel traps on a ``CSR_BAD`` code."""
    var_con, con_var = tables["var_con"], tables["con_var"]
    p_count, n_var, k = var_con.shape
    n_con = con_var.shape[1]
    nq = -(-n_con // 4)
    dev = var_con.device
    i64 = torch.int64
    var_code = _codes(var_con, tables["var_coef"], n_con)      # (P, nv, k)
    con_code = _codes(con_var, tables["con_coef"], n_var)      # (P, nc, 3)
    slots = torch.arange(1, k + 1, dtype=torch.int32, device=dev)
    var_len = ((var_code != 0) * slots).amax(dim=-1).clamp_min(1)

    # real counts: past the last row with a nonzero code (or b), and past
    # every index a real slot names
    vc, cc = var_code.to(i64), con_code.to(i64)
    named_c = torch.where((vc != 0) & (vc != BAD), vc.abs(), 0)
    named_v = torch.where((cc != 0) & (cc != BAD), cc.abs(), 0)
    b_set = (tables["b"] != 0) | torch.signbit(tables["b"])
    nv_real = torch.maximum(_last((var_code != 0).any(dim=-1)),
                            named_v.flatten(1).amax(dim=1)).clamp_min(1)
    nc_real = torch.maximum(_last((con_code != 0).any(dim=-1) | b_set),
                            named_c.flatten(1).amax(dim=1)).clamp_min(1)

    # the owners' order
    idx = torch.arange(n_var, dtype=i64, device=dev).expand(p_count, n_var)
    real_pos = idx < nv_real[:, None]       # real variables, real positions
    lens = var_len.to(i64)
    key = torch.where(real_pos, (k - lens) * n_var + idx,
                      (k + 1) * n_var + idx)
    var_pos = torch.argsort(key, dim=1)                        # pos -> var
    rank = torch.empty_like(var_pos).scatter_(1, var_pos, idx)  # var -> pos
    len_pos = torch.gather(lens, 1, var_pos)

    # each position's items: quads of slots, and single slots
    code = torch.gather(vc, 1, var_pos[:, :, None].expand(p_count, n_var, k))
    s = torch.arange(k, dtype=i64, device=dev)
    in_row = s < len_pos[:, :, None]
    real = (code != 0) & (code != BAD)
    row, neg = code.abs() - 1, (code < 0).to(i64)

    def ahead(x, j, fill):
        return torch.cat([x[..., j:], x.new_full(x.shape[:-1] + (j,), fill)],
                         dim=-1)
    start = real & (row % 4 == 0)
    for j in range(1, 4):
        start &= ahead(real, j, False) & (ahead(row, j, -1) == row + j)
    windows = k > WINDOW
    if windows:                    # a slot's place in its window
        place = (s + window_front(k)) % WINDOW
        start &= place <= WINDOW - 4
    covered = start.clone()
    for j in range(1, 4):
        covered |= torch.cat([start.new_zeros(start.shape[:-1] + (j,)),
                              start[..., :-j]], dim=-1)
    is_item = in_row & (start | ~covered)
    signs = neg + 2 * ahead(neg, 1, 0) + 4 * ahead(neg, 2, 0) \
        + 8 * ahead(neg, 3, 0)
    single = torch.where(code == 0, 4 * nq, row | (neg << 16))
    item = torch.where(start, RUN | (row // 4) | (signs << 16), single)
    if windows:
        item = torch.where((place == 0) & (s > 0), item | WIN, item)
    item = torch.where(code == BAD, (1 << 32) - 1, item)
    n_items = is_item.sum(dim=-1)                              # (P, nv)
    order = torch.cumsum(is_item.to(i64), dim=-1) - 1

    # the groups of 32 positions, each as long as its longest variable
    groups = -(-n_var // 32)
    glen = torch.zeros((p_count, groups * 32), dtype=i64, device=dev)
    glen[:, :n_var] = torch.where(real_pos, n_items, 0)
    width = glen.view(p_count, groups, 32).amax(dim=2) * 32
    goff = torch.cumsum(width, dim=1) - width
    base = (goff.repeat_interleave(32, dim=1)[:, :n_var]
            + torch.arange(n_var, device=dev) % 32)
    cap = csr_capacity(n_var, n_con, k)
    at = base[:, :, None] + 32 * order
    keep = is_item & real_pos[:, :, None] & (at < cap)
    at = torch.where(keep, at, cap)
    csr = torch.zeros((p_count, cap + 1), dtype=i64, device=dev)
    csr.scatter_(1, at.flatten(1), item.flatten(1))
    csr = csr[:, :cap].contiguous()
    csr[:, 0] = torch.where(width.sum(dim=1) > cap, (1 << 32) - 1,
                            csr[:, 0])

    info = (torch.where(real_pos, base, 0) | (n_items << LEN_SHIFT)
            | ((len_pos < k).to(i64) << TRAIL_BIT)
            | ((var_pos == 0).to(i64) << VAR0_BIT))

    # the constraints' codes over the positions, whole quads, and the
    # quads whose rows name the same variables
    crow = torch.gather(rank, 1, (cc.abs() - 1).clamp(0, n_var - 1)
                        .flatten(1)).view_as(cc)
    ccode = torch.where(cc < 0, crow | SIGN, crow)
    ccode = torch.where(cc == 0, n_var, ccode)
    ccode = torch.where(cc == BAD, 0xffff, ccode)
    con4 = torch.zeros((p_count, 4 * nq, 4), dtype=i64, device=dev)
    con4[:, :n_con, :3] = ccode
    rows4 = (con4[:, :, :3] & 0x7fff).view(p_count, nq, 4, 3)
    whole = torch.arange(4 * nq, device=dev).view(nq, 4) < n_con
    same = (rows4 == rows4[:, :, :1]).all(dim=-1).all(dim=-1) \
        & whole.all(dim=-1)
    negs = (con4[:, :, :3] & SIGN).view(p_count, nq, 4, 3) != 0
    i, j = torch.arange(4, device=dev)[:, None], torch.arange(3, device=dev)
    cascade = same & (negs == ((i != j) & (i < 3))).all(dim=-1).all(dim=-1)
    con4.view(p_count, nq, 4, 4)[:, :, 0, 3] = same.to(i64) + 2 * cascade
    return {**tables,
            "var_csr": _int(csr, 32),
            "var_info": info.contiguous(),
            "var_pos": var_pos.to(torch.int32).contiguous(),
            "con_code4": _int(con4, 16),
            "real": torch.stack([nv_real, nc_real], dim=1).to(torch.int32)}


def admm_iterate(q, v, z, yl, done, it, tables, alpha, mu, eps_stop: float,
                 max_iter: int, iters: int, sum2=None,
                 check_every: int = CHECK_EVERY):
    """Up to ``iters`` QP-ADMM iterations of every (lane, candidate) pair
    that is not done: :func:`.admm_ref.admm_iterate_ref`'s contract (its
    shapes, stop rule and ``sum2``). On CUDA ``tables`` may carry the packed
    copy of :func:`pack_tables` (else it is packed here), alpha and mu are
    made (B,) float32, the state is updated in place and returned, and
    ``check_every`` is not used: the host reads nothing."""
    if on_cpu("admm_iterate", q):
        return admm_iterate_ref(q, v, z, yl, done, it, tables, alpha, mu,
                                eps_stop, max_iter, iters, sum2,
                                check_every)
    dev = q.device
    if done.dim() != 2:
        raise ValueError(f"admm_iterate: done must be (B, P), got "
                         f"{tuple(done.shape)}")
    bsz, p_count = done.shape
    if not all(key in tables for key in PACKED):
        tables = pack_tables(tables)
    n_var, k = tables["var_con"].shape[1:]
    n_con = tables["con_var"].shape[1]
    plan = admm_plan(n_var, n_con, k)
    i16, i32, f32 = torch.int16, torch.int32, torch.float32
    for name, t, dtype, shape in (
            ("q", q, f32, (bsz, p_count * n_var)),
            ("v", v, f32, (bsz, p_count * n_var)),
            ("z", z, f32, (bsz, p_count * n_con)),
            ("yl", yl, f32, (bsz, p_count * n_con)),
            ("done", done, torch.bool, (bsz, p_count)),
            ("it", it, i32, (bsz, p_count)),
            ("var_csr", tables["var_csr"], i32, (p_count, plan["csr_cap"])),
            ("var_info", tables["var_info"], torch.int64, (p_count, n_var)),
            ("var_pos", tables["var_pos"], i32, (p_count, n_var)),
            ("con_code4", tables["con_code4"], i16,
             (p_count, 4 * -(-n_con // 4), 4)),
            ("real", tables["real"], i32, (p_count, 2)),
            ("b", tables["b"], f32, (p_count, n_con)),
            ("e", tables["e"], f32, (p_count, n_var))) + (
            () if sum2 is None else
            (("sum2", sum2, f32, (bsz, p_count)),)):
        expect("admm_iterate", name, t, dtype, shape, dev)
    alpha_l = lane_param(alpha, bsz, dev).reshape(-1).contiguous()
    mu_l = lane_param(mu, bsz, dev).reshape(-1).contiguous()
    if bsz and int(iters) > 0:
        queue = torch.zeros(p_count, dtype=i32, device=dev)
        launch("admm_iterate", "ldpc_admm_iterate", dev, q, v, z, yl, done,
               it, tables["var_csr"], tables["var_info"], tables["var_pos"],
               tables["con_code4"], tables["real"], tables["b"], tables["e"],
               alpha_l, mu_l, sum2, queue, bsz, p_count, n_var, n_con, k,
               float(eps_stop), int(max_iter), int(iters), plan["threads"],
               plan["smem_bytes"], plan["lanes"])
        _COUNT()
    return v, z, yl, done, it
