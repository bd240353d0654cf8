"""Host-side runtime pieces (counterpart of ``openimpala_tpu/io/``)."""
