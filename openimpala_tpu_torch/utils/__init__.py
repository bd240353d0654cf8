"""Direction helpers, device rule, step timing and sample volumes."""
