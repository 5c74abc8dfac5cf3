"""One module an AIR: its shape (REGISTERS, FRAME_OFFSETS,
CONSTRAINT_DEGREE, TRANSITIONS), its transition constraints over whole
(N,) int64 tensors, its boundary constraints, and its witness (``trace``),
each written from the statement's definition."""
