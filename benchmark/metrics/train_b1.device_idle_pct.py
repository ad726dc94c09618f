"""train_b1.device_idle_pct: portbench.readers.device_idle_pct in cell unetpres-n16.train-b1 (moves train_b1_samples_per_s)."""

from portbench.readers import device_idle_pct as read  # noqa: F401
