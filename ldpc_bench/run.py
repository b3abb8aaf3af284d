"""One run of one cell of the benchmark of ``ldpc_tpu_torch``.

    python3 -m ldpc_bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the checkout's root, on a machine with as many CUDA devices as the cell
asks for. In order: read the cell's files (``cell.py``); build or load the
port's kernels and derive G from the code (the C++ host core); draw the
codeword table from the seed on the device; build the decoder with
``make_decoder``; warm up with one block of the cell's shape; then call the
sweep's entry, ``run_experiment``, on successive blocks of trials, each with
its own noise seed, until ``--seconds`` have passed (a block started in time
runs to its end). ``cw_per_s`` is every trial of the window over its wall
time, ended by a device synchronise; ``setup_s`` runs from the process's
start to the first timed block.

With ``--trace 1`` a fixed number of blocks (the cell's ``trace_blocks``)
runs under ``torch.profiler`` instead, and the cell's per-layer metrics are
read from that slice by their readers (``metrics/<name>.py``).

The sampled blocks are recorded trial by trial (``record.py``), from the
batched runner or the streamed one alike, into buffers allocated during
set-up. Then they are judged against the plain reference (``check.py``),
and the last line of standard output is the result: one JSON
object with ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` when traced), and last ``check``, each number compared
beside its limit, as on the last lines of standard error.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ldpc_tpu"})


def block_seed(seed: int, k: int) -> int:
    """The 32-bit noise seed of block ``k`` (``-1``: the warm-up block)."""
    digest = hashlib.blake2b(f"{seed}:{k}".encode(), digest_size=4).digest()
    return int.from_bytes(digest, "little")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def forbidden_loaded() -> bool:
    """True, and says so on standard error, when JAX or the JAX package is
    loaded."""
    bad = forbidden_modules()
    if bad:
        print(f"ldpc_bench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
    return bool(bad)


class Sampler:
    """A uniform sample of ``size`` blocks of the window, drawn from the
    seed (reservoir sampling): ``slot(k)`` says where block ``k`` is kept,
    or None."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(seed ^ 0x5A17)
        self.size = size

    def slot(self, k: int):
        if k < self.size:
            return k
        j = self.rng.randrange(k + 1)
        return j if j < self.size else None


def card_stamp(index: int) -> str:
    """``name, power.limit`` as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, sizes=None, prepare=None) -> int:
    """Run a cell; returns the exit code. ``device``, ``sizes`` (``batch``,
    ``block_batches``, ``check_blocks``, ``trace_blocks``) and ``prepare``
    (called with the decoder) are for tests on the CPU."""
    args = _args(argv)
    from .cell import Cell
    try:
        cell = Cell(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        print(f"ldpc_bench: {exc}", file=sys.stderr)
        return 2
    import torch
    if device is None:
        if not torch.cuda.is_available():
            print("ldpc_bench: torch.cuda.is_available() is false",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"ldpc_bench: {cell.name} needs {cell.chips} CUDA devices, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 3
        device = "cuda:0"
    dev = torch.device(device)
    torch.set_num_threads(2)
    sz = {"batch": cell.config["batch"],
          "block_batches": cell.traffic["block_batches"],
          "check_blocks": cell.spec["check_blocks"],
          "trace_blocks": cell.spec["trace_blocks"], **(sizes or {})}
    batch, block_trials = sz["batch"], sz["batch"] * sz["block_batches"]
    snr = float(cell.traffic["snr_db"])

    from ldpc_tpu_torch.channel.awgn import gen_random_codewords
    from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
    from ldpc_tpu_torch.codes.io import read_pcm
    from ldpc_tpu_torch.config import DecoderConfig
    from ldpc_tpu_torch.decoders import make_decoder
    from ldpc_tpu_torch.harness.experiment import run_experiment

    from .check import Block, judge, verdict
    from .counts.peaks import peaks
    from .record import Recorder
    from .trace import Context, breakdown, profile

    stages = {}

    def stage(label):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stages[label] = time.perf_counter() - T0 - sum(stages.values())

    stage("imports")
    if dev.type == "cuda":
        # the port's libraries, built on a checkout's first run: recorded
        # apart, and part of setup_s as in any run that compiles
        from ldpc_tpu_torch import _native
        from ldpc_tpu_torch.ops import _build
        _native.load()
        _build.load()
        stage("build")
    h = read_pcm(str(cell.code_path))
    g, ok = gf2_nullspace(h)
    if not ok:
        print(f"ldpc_bench: {cell.code_path} is singular", file=sys.stderr)
        return 2
    stage("code")
    gen = torch.Generator(device=dev).manual_seed(args.seed % 2**63)
    codewords = gen_random_codewords(g, block_trials, gen, dev)
    stage("codewords")
    decoder = make_decoder(cell.config["decoder"], h,
                           DecoderConfig(**cell.config["decoder_config"]),
                           device=dev)
    stage("decoder")
    if prepare is not None:
        prepare(decoder)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ctx = Context(decoder, cell.config, dev, peaks(name))
    rec = Recorder(decoder, block_trials, sz["check_blocks"], ctx)

    def run_block(k):
        return run_experiment(decoder, h, codewords, snr,
                              block_seed(args.seed, k), batch_size=batch,
                              device=dev, warmup=False)

    # warm-up: every shape of the cell, recorded as a sampled block is, so
    # that the sample's buffers and copies exist before the window
    with rec.block(0):
        run_block(-1)
    rec.allocate()
    stage("warmup")
    readers = {}
    if args.trace:
        for m in cell.per_layer:
            readers[m["name"]] = mod = cell.metric(m["name"])
            if hasattr(mod, "install"):
                mod.install(ctx)
    sampler = Sampler(args.seed, sz["check_blocks"])
    kept = [None] * sz["check_blocks"]
    blocks = []

    def window():
        k = 0
        t_start = time.perf_counter()
        while True:
            slot = sampler.slot(k)
            with rec.block(slot):
                res = run_block(k)
            block = Block(k, block_seed(args.seed, k), [
                res.total, res.correct, res.pseudo, res.sum_hamming,
                res.sum_hamming_ok, res.sum_hamming_wrong,
                res.sum_iterations, res.sum_dropped])
            if slot is not None:
                kept[slot] = block
            blocks.append(block)
            ctx.trials += res.total
            k += 1
            if args.trace and k >= sz["trace_blocks"]:
                break
            if not args.trace and time.perf_counter() - t_start >= \
                    args.seconds:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return t_start

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T0
    summary = None
    if args.trace:
        summary = profile(ctx, window)
    else:
        t_start = window()
        wall = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if forbidden_loaded():
        return 4

    attempted = len(blocks) * block_trials
    failed = abs(attempted - sum(b.counters[0] for b in blocks))
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if args.trace:
        for mname, mod in readers.items():
            value = mod.read(ctx, summary)
            if value is not None:
                metrics[mname] = {"value": value, "unit": units[mname]}
    else:
        # an end-to-end metric split by cells (cw_per_s.bp) is its quantity
        values = {"cw_per_s": attempted / wall, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"].split(".")[0]],
                                  "unit": m["unit"]}

    # the program's state goes before the reference runs
    del codewords
    slots = [s for s, b in enumerate(kept) if b is not None]
    whole = bool(slots) and rec.whole(slots)
    sample = []
    for s in slots:
        kept[s].trials = rec.rows(s)
        sample.append(kept[s])
    numbers = {}
    t_check = time.perf_counter()
    if whole:
        ref = cell.reference()
        tables = ref.prepare(h, cell.reference_config(), dev)
        numbers = judge(ref, tables, h, args.seed, snr, sample, batch, dev)
    ok, shown = verdict(numbers, cell.spec.get("limits", {}))
    correct = ok and whole and failed == 0

    device_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": name, "count": cell.chips,
                  "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_out}
    if summary is not None:
        device_out["busy_s"] = summary["busy_us"] / 1e6
        device_out["window_s"] = summary["window_us"] / 1e6
        out["breakdown"] = breakdown(summary)
    card = card_stamp(dev.index or 0) if dev.type == "cuda" else "cpu"
    total = max(1, sum(b.counters[0] for b in blocks))
    out["about"] = {"card": card, "blocks": len(blocks),
                    "fer": 1.0 - sum(b.counters[1] for b in blocks) / total,
                    "mean_iterations": sum(b.counters[6] for b in blocks)
                    / total,
                    "block_trials": block_trials,
                    "checked_blocks": [b.index for b in sample],
                    "check_s": time.perf_counter() - t_check,
                    "setup_stages_s": stages,
                    "bounds": ctx.notes}
    if summary is not None:
        out["about"]["trace"] = {k: summary[k] for k in
                                 ("batches", "trials", "host_reads")}
    out["check"] = shown
    print(f"ldpc_bench: {cell.name} seed {args.seed} card {card}; "
          f"{len(blocks)} blocks of {block_trials} trials; bounds "
          f"{ctx.notes}", file=sys.stderr)
    if not whole:
        print("ldpc_bench: no whole sampled block to check", file=sys.stderr)
    for key, v in shown.items():
        print(f"check {key} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    if forbidden_loaded():              # the readers and the reference too
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
