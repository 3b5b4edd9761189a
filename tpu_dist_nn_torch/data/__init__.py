"""Host-side batch feeding."""
