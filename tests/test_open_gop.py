"""Open GOP: periodic intra inside a B pyramid codes CRA anchors with
RASL leading pictures (reference: open_gop default src/cfg.c:120,
NAL-type logic src/encoderstate.c:1171-1272).  POC continues across
CRAs; the leading B pictures reference across the CRA; the oracle
decoder must reconstruct bit-exactly."""

import numpy as np
import pytest

from kvazaar_jax.api import Encoder
from kvazaar_jax.bitstream.decoder import decode_stream, split_annexb
from kvazaar_jax.config import Config
from kvazaar_jax.constants import NAL_CRA_NUT, NAL_RASL_R

pytestmark = pytest.mark.smoke

W, H, N = 96, 64, 17


def clip(n=N, w=W, h=H, seed=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        y = np.clip(120 + 50 * np.sin((xx + 2 * i) / 13.0)
                    * np.cos(yy / 9.0) + rng.normal(0, 4, (h, w)),
                    0, 255).astype(np.uint8)
        cb = np.full((h // 2, w // 2), 118, np.uint8)
        cr = np.full((h // 2, w // 2), 130, np.uint8)
        out.append((y, cb, cr))
    return out


def test_open_gop_cra_rasl_decode():
    cfg = Config(width=W, height=H, qp=30, gop_len=8, intra_period=8,
                 intra_min_cu=8, intra_max_cu=32, inter_min_cu=8,
                 inter_max_cu=32, bipred=True)
    enc = Encoder(cfg)
    frames = clip()
    results = []
    for f in frames:
        results.extend(enc.encode(*f))
    results.extend(enc.flush())
    assert len(results) == N
    stream = b"".join(chunks for chunks, _i, _r in results)
    nal_types = [t for t, _tid, _r in split_annexb(stream)]
    assert NAL_CRA_NUT in nal_types, nal_types
    assert NAL_RASL_R in nal_types, nal_types
    # Periodic CRAs: POC 8 and 16 anchors (period 8).
    assert nal_types.count(NAL_CRA_NUT) == 2
    infos = {i.poc: i for _c, i, _r in results}
    assert infos[8].nal_type == NAL_CRA_NUT
    assert infos[8].slice_type == 2          # I slice
    # Layer QPs still apply to the non-anchor pictures.
    assert infos[4].qp == cfg.qp + 2

    # Oracle decode, coding order == results order: bit-exact recon.
    dec = decode_stream(stream, enc._intra.params)
    assert len(dec) == N
    for k, ((dy, dcb, dcr), _fd) in enumerate(dec):
        rec_y, rec_cb, rec_cr = results[k][2]
        np.testing.assert_array_equal(dy[:H, :W], rec_y)
        if rec_cb is not None:
            np.testing.assert_array_equal(dcb[:H // 2, :W // 2],
                                          rec_cb)
            np.testing.assert_array_equal(dcr[:H // 2, :W // 2],
                                          rec_cr)
