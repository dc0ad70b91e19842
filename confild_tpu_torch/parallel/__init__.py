"""The port's multi-device layer (``confild_tpu/parallel``): a data mesh over
the ranks of a ``torch.distributed`` process group."""
