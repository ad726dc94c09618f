"""train.library_ms_per_step: portbench.readers.library_ms_per_step in cell unetpres-n16.train-l128 (moves train_samples_per_s)."""

from portbench.readers import library_ms_per_step as read  # noqa: F401
