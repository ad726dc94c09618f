"""train_b1.step_ms: portbench.readers.step_ms in cell unetpres-n16.train-b1 (moves train_b1_samples_per_s)."""

from portbench.readers import step_ms as read  # noqa: F401
