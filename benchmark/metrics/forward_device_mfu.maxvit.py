"""The forwards' share of the card's dense bfloat16 peak in the MaxViT
cell: ``forward_device_mfu.swin``'s reader, which depends on no model (the
FLOP count is the runner's ``forward_flops``, from the configuration's
reference), read under this cell's name."""

from benchmark.lib.cell import metric_reader

read = metric_reader("forward_device_mfu.swin")
