"""train.step_ms: portbench.readers.step_ms in cell unetpres-n16.train-l128 (moves train_samples_per_s)."""

from portbench.readers import step_ms as read  # noqa: F401
