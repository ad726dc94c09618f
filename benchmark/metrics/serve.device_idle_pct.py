"""serve.device_idle_pct: portbench.readers.device_idle_pct in cell unetpres-n16.serve-r512 (moves serve_tiles_per_s)."""

from portbench.readers import device_idle_pct as read  # noqa: F401
