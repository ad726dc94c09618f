"""serve.host_issue_ms: portbench.readers.host_issue_ms in cell unetpres-n16.serve-r512 (moves serve_tiles_per_s)."""

from portbench.readers import host_issue_ms as read  # noqa: F401
