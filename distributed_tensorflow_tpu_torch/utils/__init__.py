"""Host-side utilities: checksums, pytree flattening, metrics sinks."""
