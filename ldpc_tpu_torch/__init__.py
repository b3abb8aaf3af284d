"""ldpc_tpu_torch: the LDPC decoding framework in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside the JAX reference ``ldpc_tpu``; every module here has
its namesake there. This package imports torch and numpy only, never JAX, and
never ``ldpc_tpu`` (whose ``__init__`` imports JAX).

Main path (``python -m ldpc_tpu_torch.bench``): ``codes.io.read_pcm`` ->
``codes.gf2.gf2_nullspace`` -> ``channel.awgn.gen_random_codewords`` ->
``harness.experiment.run_experiment`` with ``decoders.bp.BPDecoder``, which on
a CUDA tensor runs the fused decode kernel in ``csrc/bp_decode.cu``.

Sweep app (``python -m ldpc_tpu_torch.apps.benchmark --decoders bp alp``):
the same harness per (decoder, SNR), writing the reference's ``report.csv``;
``decoders.alp.ALPDecoder`` re-solves its cut LPs with
``ops.lp_solver.pdhg_box_lp_fused``, whose chunks run the PDHG kernel in
``csrc/pdhg_chunk.cu`` on a CUDA tensor; ``decoders.agc_alp.AGCALPDecoder``
(``--decoders agc-alp``) solves with the IPM of ``ops.ipm_solver`` (kernels
``csrc/gemv.cu``, ``csrc/normal_build.cu``, ``csrc/chol_diag_inv.cu``) and
adds Gaussian-elimination cuts (``csrc/gf2_gauss.cu``).
"""
