"""Frame formats (host side)."""
