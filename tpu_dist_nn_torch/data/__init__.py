"""Host-side batch feeding and the LM text pipeline."""
