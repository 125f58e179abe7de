"""Math foundations: batched vector, matrix and bounding-box operations
(the reference's src/math and src/geometry scalar classes)."""
from . import bound, mat4, vec

__all__ = ["vec", "mat4", "bound"]
