"""The channel kernel (``csrc/awgn_channel.cu``, ``ops/channel_kernel.py``)
and the runners that call it.

On the CPU: the wrapper's refusals; the key and the kernel's uint32 hash,
pair layout and coalesced store pattern, emulated, against the twin; and
every runner's counters and LLRs against the plain path (y, then
``scale * y``, then the hard-decision count, as separate ops). On the card (marked ``gpu``; ``python -m pytest
tests/test_torch_channel_kernel.py -m gpu --noconftest``): the kernel bit
for bit with the twin (:func:`channel_ref` on the same CUDA tensors) in y,
the LLRs and the count, and one launch a batch in each runner. This file
imports nothing of JAX.
"""
import os

import numpy as np
import pytest
import torch

from ldpc_tpu_torch.channel import awgn
from ldpc_tpu_torch.codes.gf2 import gf2_nullspace
from ldpc_tpu_torch.codes.io import read_pcm
from ldpc_tpu_torch.decoders.admm import QPADMMDecoder
from ldpc_tpu_torch.decoders.bp import BPDecoder
from ldpc_tpu_torch.harness import experiment
from ldpc_tpu_torch.harness.experiment import (COUNTERS, run_experiment,
                                               run_multi_snr_experiment)
from ldpc_tpu_torch.ops import channel_kernel

CPU = torch.device("cpu")
DATA = os.path.join(os.path.dirname(__file__), "..", "data")
SEEDS = [0, 2**31 + 7, -1]
M32 = np.uint64(0xFFFFFFFF)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _h():
    return read_pcm(os.path.join(DATA, "H.txt"))


def _codewords(h, num, seed):
    g, _ = gf2_nullspace(h)
    rng = np.random.default_rng(seed)
    return ((rng.integers(0, 2, (num, g.shape[0])) @ g) % 2).astype(np.uint8)


# --- the wrapper's refusals (CPU) ------------------------------------------

def _args(**kw):
    args = dict(bits=torch.zeros((4, 6), dtype=torch.uint8),
                trial_idx=torch.arange(4), key=1, sigma=0.5, scale=2.0)
    args.update(kw)
    return args


@pytest.mark.parametrize("kw,err,words", [
    ({}, ValueError, "must be a CUDA tensor"),
    ({"bits": torch.zeros((4, 6), dtype=torch.float32)}, TypeError,
     "bits must be torch.uint8"),
    ({"bits": torch.zeros((4, 6), dtype=torch.bool)}, TypeError,
     "bits must be torch.uint8"),
    ({"bits": torch.zeros((6, 4), dtype=torch.uint8).t()}, ValueError,
     "bits must be contiguous"),
    ({"bits": torch.zeros((2, 4, 6), dtype=torch.uint8)}, ValueError,
     "bits must be 2-D"),
    ({"trial_idx": torch.arange(4, dtype=torch.int32)}, TypeError,
     "trial_idx must be torch.int64"),
    ({"trial_idx": torch.arange(5)}, ValueError, "trial_idx must have shape"),
    ({"sigma": torch.ones(4, dtype=torch.float64)}, TypeError,
     "sigma must be torch.float32"),
    ({"scale": torch.ones(3)}, ValueError, "scale must have shape"),
    ({"key": 2**32}, ValueError, "key must be a 32-bit value"),
    ({"key": -1}, ValueError, "key must be a 32-bit value"),
])
def test_wrapper_refuses(kw, err, words):
    before = channel_kernel.LAUNCHES
    with pytest.raises(err, match=words):
        channel_kernel.awgn_channel(**_args(**kw))
    assert channel_kernel.LAUNCHES == before


def test_cpu_tensors_take_the_twin():
    bits = torch.from_numpy(_codewords(_h(), 8, 2))
    idx = torch.arange(8)
    before = channel_kernel.LAUNCHES
    got = awgn.channel(bits, idx, 4, 0.75, 3.5)
    want = awgn.channel_ref(bits, idx, 4, 0.75, 3.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert channel_kernel.LAUNCHES == before


# --- the kernel's arithmetic, emulated (CPU) --------------------------------

def _mix32(x):
    """lowbias32 on uint32 arrays (numpy wraps mod 2**32), as the kernel."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


@pytest.mark.parametrize("seed", SEEDS + [2**40 + 3, -(2**33) - 5])
def test_noise_key_equals_the_twins(seed):
    twin = awgn._mix32(torch.full((1,), (seed & 0xFFFFFFFF) ^ 0x9E3779B9,
                                  dtype=torch.int64))
    assert awgn.noise_key(seed) == int(twin)


def _kernel_normals(seed, trials, n):
    """The kernel's normals: the hash in uint32 per pair (thread) ``p`` at
    counters 2p and 2p + 1, Box-Muller rounded step by step as the
    kernel rounds it, the last pair's second normal dropped for odd n."""
    key = np.uint32(awgn.noise_key(seed))
    t = (trials.astype(np.int64).view(np.uint64) & M32).astype(np.uint32)
    lane = _mix32(key ^ t)[:, None]
    ctr = 2 * np.arange((n + 1) // 2, dtype=np.uint32)[None, :]
    t = t[:, None]
    h0 = _mix32(_mix32(lane ^ ctr) + t)
    h1 = _mix32(_mix32(lane ^ (ctr + np.uint32(1))) + t)
    u1 = (torch.from_numpy(h0.astype(np.float64)) + 1.0) * 2.0**-32
    theta = (2.0 * 3.141592653589793 * 2.0**-32) * torch.from_numpy(
        h1.astype(np.float64))
    r = torch.sqrt(-2.0 * torch.log(u1))
    z = torch.stack([(r * torch.cos(theta)).float(),
                     (r * torch.sin(theta)).float()], dim=-1)
    return z.reshape(len(trials), -1)[:, :n]


@pytest.mark.parametrize("n", [1, 4, 280, 281, 640])
@pytest.mark.parametrize("seed", SEEDS)
def test_uint32_hash_equals_the_twins(seed, n):
    trials = np.concatenate([np.arange(5), 2**32 - 2 + np.arange(4),
                             [2**40 + 17, 2**62 + 1]]).astype(np.int64)
    want = awgn.awgn_noise(seed, torch.from_numpy(trials), n)
    assert torch.equal(_kernel_normals(seed, trials, n), want)


def _plan(n):
    """(warps a lane, lanes a block) of ``ldpc_awgn_channel``."""
    warps = min(max(-(-((n + 1) // 2) // 32), 1), 16)
    return warps, 1 if warps >= 8 else 8 // warps


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 280, 281, 640, 1023,
                               1024, 1025, 2049, 4097])
def test_store_pattern_writes_each_float_once(n):
    """The kernel's loop over pairs and its two shuffled stores a warp
    write float j of the row from component j % 2 of pair j // 2, each
    float once, whatever the parity of n and the warps a lane."""
    pairs = (n + 1) // 2
    warps, lanes = _plan(n)
    assert lanes * warps <= 16
    row = np.full(n, -1, np.int64)
    for part in range(warps):
        for base in range(part * 32, pairs, warps * 32):
            for tid in range(32):
                src = tid >> 1
                for j, pair in ((2 * base + tid, base + src),
                                (2 * base + 32 + tid, base + 16 + src)):
                    if j < n:
                        assert row[j] == -1 and pair < pairs
                        row[j] = 2 * pair + (tid & 1)
    assert np.array_equal(row, np.arange(n))


# --- the runners against the plain path (CPU) -------------------------------

def _plain_channel(bits, trial_idx, seed, sigma, scale):
    """The plain ops one at a time: y, then scale * y, then the
    hard-decision count."""
    z = awgn.awgn_noise(seed, trial_idx, bits.shape[-1])
    if isinstance(sigma, torch.Tensor):
        y = awgn.bpsk(bits) + sigma[:, None] * z
        llrs = scale[:, None] * y
    else:
        y = awgn.bpsk(bits) + sigma * z
        llrs = scale * y
    return y, llrs, torch.where(bits == 0, y <= 0, y > 0).sum(dim=-1)


class _Recorded:
    """Records the LLRs each runner hands the decoder."""

    def __init__(self, dec):
        self.llrs = []
        for name in ("decode_batch", "stream_init"):
            if hasattr(dec, name):
                inner = getattr(dec, name)

                def wrapped(llrs, inner=inner):
                    self.llrs.append(llrs.clone())
                    return inner(llrs)
                setattr(dec, name, wrapped)


def _run(runner, h, cw):
    if runner == "batched":
        dec = BPDecoder(h, max_iter=12, device=CPU)
        rec = _Recorded(dec)
        res = [run_experiment(dec, h, cw, 1.0, 2**31 + 7, batch_size=24,
                              device=CPU)]
    elif runner == "streamed":
        dec = QPADMMDecoder(h, max_iter=200, device=CPU)
        dec.stream_chunk_iters = 64
        rec = _Recorded(dec)
        res = [run_experiment(dec, h, cw, 1.0, -1, batch_size=16,
                              device=CPU, streaming=True)]
    else:
        dec = BPDecoder(h, max_iter=12, device=CPU)
        rec = _Recorded(dec)
        res = run_multi_snr_experiment(dec, h, cw, [0.0, 2.5], 0,
                                       batch_size=20, device=CPU)
    return [tuple(getattr(r, k) for k in COUNTERS) for r in res], rec.llrs


@pytest.mark.parametrize("runner", ["batched", "streamed", "multi_snr"])
def test_runners_equal_the_plain_path(runner, monkeypatch):
    h = _h()
    cw = _codewords(h, 40, 3)
    counters, llrs = _run(runner, h, cw)
    monkeypatch.setattr(experiment, "channel", _plain_channel)
    want_counters, want_llrs = _run(runner, h, cw)
    assert counters == want_counters
    assert counters[0][0] == 40 and len(llrs) == len(want_llrs) > 1
    assert all(torch.equal(a, b) for a, b in zip(llrs, want_llrs))


# --- the kernel on the card -------------------------------------------------

def _card_inputs(dev, bsz, n, seed):
    """Codeword bits gathered from a table (contiguous) and trial indices
    past 2**32 as a strided view, as the streamed refill gathers them."""
    gen = torch.Generator(device=dev).manual_seed(seed % 2**63 + bsz + n)
    table = torch.randint(0, 2, (bsz + 3, n), generator=gen, device=dev,
                          dtype=torch.uint8)
    rows = torch.randperm(bsz + 3, generator=gen, device=dev)[:bsz]
    bits = table.index_select(0, rows)
    big = 2**32 + 7 + 3 * torch.arange(2 * bsz, device=dev)
    trial_idx = big.flip(0)[::2]
    assert not trial_idx.is_contiguous() or bsz == 1
    return bits, trial_idx


def _lane_factors(dev, bsz, seed):
    sigmas, scales = awgn.snr_table([-3.0, 0.0, 2.5], dev)
    sid = torch.randint(0, 3, (bsz,), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            seed % 2**63))
    return sigmas[sid], scales[sid]


def _assert_kernel_equals_twin(bits, trial_idx, seed, sigma, scale):
    before = channel_kernel.LAUNCHES
    got = channel_kernel.awgn_channel(bits, trial_idx, awgn.noise_key(seed),
                                      sigma, scale)
    assert channel_kernel.LAUNCHES == before + 1
    want = awgn.channel_ref(bits, trial_idx, seed, sigma, scale)
    for name, a, b in zip(("y", "llr", "hd"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        differ = (a != b).sum().item()
        assert differ == 0, f"{name}: {differ} of {a.numel()} differ"


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["scalar", "lanes"])
@pytest.mark.parametrize("n", [280, 281, 640])
@pytest.mark.parametrize("bsz", [1, 256, 8192])
@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_equals_twin_on_the_card(seed, bsz, n, form, cuda_device):
    bits, trial_idx = _card_inputs(cuda_device, bsz, n, seed)
    if form == "scalar":
        sigma, scale = awgn.noise_scales(-3.0)
    else:
        sigma, scale = _lane_factors(cuda_device, bsz, seed)
    _assert_kernel_equals_twin(bits, trial_idx, seed, sigma, scale)


@pytest.mark.gpu
def test_ten_million_normals_on_the_card(cuda_device):
    bits, trial_idx = _card_inputs(cuda_device, 16384, 640, 5)
    assert bits.numel() >= 10**7
    _assert_kernel_equals_twin(bits, trial_idx, 2**31 + 7,
                               *awgn.noise_scales(0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("snr", [-3.0, 0.0, 4.0])
def test_channel_functions_on_the_card(snr, cuda_device):
    """transmit, channel_llr and channel with per-lane factors on CUDA
    tensors (one launch each) give what their plain ops give on the same
    tensors; the optimizer's (P, T, n) batch shares each trial's noise."""
    bits, idx = _card_inputs(cuda_device, 512, 280, 11)
    sigma, _ = awgn.noise_scales(snr)
    var = awgn.llr_variance(snr)
    y_twin = awgn.bpsk(bits) + sigma * awgn.awgn_noise(11, idx, 280)
    before = channel_kernel.LAUNCHES
    assert torch.equal(awgn.transmit(bits, snr, 11, idx), y_twin)
    y, lam = awgn.channel_llr(bits, snr, 11, idx)
    assert torch.equal(y, y_twin) and torch.equal(lam, 2.0 * y_twin / var)
    sig_l, sc_l = _lane_factors(cuda_device, 512, 3)
    y_l, lam_l, _ = awgn.channel(bits, idx, 11, sig_l, sc_l)
    assert torch.equal(y_l, awgn.bpsk(bits) + sig_l[:, None]
                       * awgn.awgn_noise(11, idx, 280))
    assert torch.equal(lam_l, sc_l[:, None] * y_l)
    stacked = torch.stack([bits, bits.flip(0)])[:, 100:300]
    y3, l3, hd3 = awgn.channel(stacked, idx[100:300], 11,
                               *awgn.noise_scales(snr))
    want = awgn.channel_ref(stacked, idx[100:300], 11,
                            *awgn.noise_scales(snr))
    assert all(torch.equal(a, b) for a, b in zip((y3, l3, hd3), want))
    assert channel_kernel.LAUNCHES == before + 4


@pytest.mark.gpu
def test_one_launch_a_batch_in_every_runner(cuda_device):
    h = _h()
    cw = _codewords(h, 96, 8)
    dec = BPDecoder(h, max_iter=20, device=cuda_device)
    launches, batches = channel_kernel.LAUNCHES, experiment.COUNTS["batches"]
    run_experiment(dec, h, cw, 1.0, 5, batch_size=40, device=cuda_device)
    assert experiment.COUNTS["batches"] - batches == 3 + 2   # warm-up: 2
    assert channel_kernel.LAUNCHES - launches == 5
    launches, batches = channel_kernel.LAUNCHES, experiment.COUNTS["batches"]
    run_multi_snr_experiment(dec, h, cw, [0.0, 2.0], 5, batch_size=64,
                             device=cuda_device)
    assert experiment.COUNTS["batches"] - batches == 3 + 1   # warm-up: 1
    assert channel_kernel.LAUNCHES - launches == 4
    adm = QPADMMDecoder(h, max_iter=300, device=cuda_device)
    adm.stream_chunk_iters = 64
    chunks = []
    inner = adm.stream_chunk

    def counted(st):
        chunks.append(1)
        return inner(st)
    adm.stream_chunk = counted
    launches = channel_kernel.LAUNCHES
    res = run_experiment(adm, h, cw, 1.0, 5, batch_size=32,
                         device=cuda_device, streaming=True)
    assert res.total == 96
    # make_lane: once a stream start (warm-up and run), once a chunk
    assert channel_kernel.LAUNCHES - launches == len(chunks) + 2
