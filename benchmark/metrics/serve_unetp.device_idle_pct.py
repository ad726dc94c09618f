"""serve_unetp.device_idle_pct: portbench.readers.device_idle_pct in cell unetp-128.serve-r512 (moves serve_unetp_tiles_per_s)."""

from portbench.readers import device_idle_pct as read  # noqa: F401
