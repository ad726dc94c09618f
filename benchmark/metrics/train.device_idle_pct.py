"""train.device_idle_pct: portbench.readers.device_idle_pct in cell unetpres-n16.train-l128 (moves train_samples_per_s)."""

from portbench.readers import device_idle_pct as read  # noqa: F401
