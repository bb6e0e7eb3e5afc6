"""Device-side encoder: batched search + wavefront reconstruction.

The reference encodes each LCU in a recursive, pointer-chasing worker
(src/search.c:424, scheduled by src/threadqueue.c).  The device design
inverts this (SURVEY.md §7): mode search is one dense, fully batched
program over every block of the frame; the sequential-by-spec
reconstruction dependencies are honored by a lax.scan over wavefront
steps whose gather/scatter indices are precomputed host-side per frame
geometry.
"""
