"""Host-side bitstream plane: bit I/O, CABAC, headers, syntax serialization.

This is this encoder's analogue of the reference's entropy & bitstream
plane (SURVEY.md §2.4): the device computes syntax-element tensors; this
package turns them into a spec-conformant HEVC bitstream.  Everything here
is sequential-by-nature and runs on the host (reference: src/bitstream.c,
src/cabac.c, src/context.c, src/encode_coding_tree.c,
src/encoder_state-bitstream.c).
"""
