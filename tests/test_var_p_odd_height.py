"""Variable-tree P frames on a coded height that 32x32 blocks do not
tile (48 here, 240 at 416x240): the ultrafast shape (fixed 16 intra
grid, 8..16 inter trees) must encode and decode bit-exactly without
requiring a 32 plan."""

import pytest

from kvazaar_jax.api import Encoder
from kvazaar_jax.config import Config
from tests.test_var_inter import (_assert_decode_matches, _clip,
                                  _encode_all)

pytestmark = pytest.mark.smoke


def test_var_p_height_not_multiple_of_32():
    w, h = 96, 48
    frames = _clip(2, w, h, seed=19)
    cfg = Config(width=w, height=h, qp=32, intra_min_cu=16,
                 intra_max_cu=16, inter_min_cu=8, inter_max_cu=16,
                 intra_period=0, hash="md5")
    enc = Encoder(cfg)
    stream, res = _encode_all(enc, frames)
    _assert_decode_matches(stream, enc._intra.params, res, w, h)
