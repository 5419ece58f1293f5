"""Per-arch configs (--arch <id>); see registry.py."""
