"""One module an AIR: its shape (REGISTERS, FRAME_OFFSETS,
CONSTRAINT_DEGREE, TRANSITIONS), its transition constraints over whole
(N,) int64 tensors, its boundary constraints, and its witness (``trace``),
each written from the statement's definition.  An AIR whose statement has
public inputs also has ``PUBLIC``, its default statement's, and takes them
as ``boundary(T, public)`` and ``trace(T, public)``."""
