"""Lock-step campaigns: studies as a batch axis."""
