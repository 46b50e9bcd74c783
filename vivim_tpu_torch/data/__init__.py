"""Host-side clip dataset and loader (numpy)."""
