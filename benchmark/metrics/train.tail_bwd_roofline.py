"""train.tail_bwd_roofline: portbench.spans.tail_bwd_roofline in cell unetpres-n16.train-l128 (moves train_samples_per_s)."""

from portbench.spans import tail_bwd_roofline as read  # noqa: F401
