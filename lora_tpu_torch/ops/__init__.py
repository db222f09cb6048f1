"""Array ops of the port: torch forms on the device, numpy tables built on the host."""
