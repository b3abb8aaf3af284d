"""Multi-device trial sharding over ``torch.distributed`` (counterpart of
``ldpc_tpu/parallel``)."""
