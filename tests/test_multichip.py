"""Within-frame sharding: layout invariance + real collectives.

The analogue of the reference's tests/test_owf_wpp_tiles.sh matrix: the
same frame must produce bit-identical results at every device-mesh
layout, and the sharded program must actually exchange halos over the
mesh (collective-permute in the compiled HLO), not gather everything.

Runs on a virtual multi-device CPU mesh in a subprocess that sets its
own device count and platform."""

import os
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.heavy

_SCRIPT = textwrap.dedent("""
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from kvazaar_jax.ops.deblock import deblock_frame
    from kvazaar_jax.parallel.sharding import deblock_frame_sharded

    rng = np.random.default_rng(0)
    H, W, CU, QP = 128, 128, 16, 30
    y = jnp.asarray(rng.integers(0, 255, (H, W), np.int32))
    cb = jnp.asarray(rng.integers(0, 255, (H // 2, W // 2), np.int32))
    cr = jnp.asarray(rng.integers(0, 255, (H // 2, W // 2), np.int32))

    ry, rcb, rcr = deblock_frame(y, cb, cr, QP, CU)
    ry, rcb, rcr = np.asarray(ry), np.asarray(rcb), np.asarray(rcr)

    hlo_checked = False
    for n in (1, 2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:n]), ("rows",))
        fn = jax.jit(lambda a, b, c: deblock_frame_sharded(
            a, b, c, QP, CU, mesh))
        sy, scb, scr = fn(y, cb, cr)
        assert np.array_equal(np.asarray(sy), ry), f"luma differs at {n}-way"
        assert np.array_equal(np.asarray(scb), rcb), f"cb differs at {n}-way"
        assert np.array_equal(np.asarray(scr), rcr), f"cr differs at {n}-way"
        if n == 4:
            txt = fn.lower(y, cb, cr).compile().as_text()
            assert ("collective-permute" in txt or "ppermute" in txt), \\
                "no halo-exchange collective in HLO"
            hlo_checked = True
    assert hlo_checked
    print("MULTICHIP-OK")
""")


def test_sharded_deblock_layout_invariant():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "MULTICHIP-OK" in r.stdout


def test_sharded_p_search_me_halo_layout_invariant():
    """Band-sharded P-frame ME + MC with search-window halo exchange
    (src/encoderstate.h:170-186 exchange set): MVs and MC pixels must
    be bit-identical at 1/2/4/8-way mesh sizes, and the HLO must carry
    the collective-permute halo."""
    script = r"""
import numpy as np
import jax
from jax.sharding import Mesh
from kvazaar_jax.parallel.sharding import p_search_mc_bands_sharded

rng = np.random.default_rng(5)
h, w = 128, 64
ref = rng.integers(0, 256, (h, w)).astype(np.int32)
# cur = ref shifted: real motion for the search to find
cur = np.roll(ref, (3, -2), (0, 1)).astype(np.int32)
base_mv = base_mc = None
for n in (1, 2, 4, 8):
    mesh = Mesh(np.array(jax.devices()[:n]), ("rows",))
    fn = jax.jit(lambda a, b: p_search_mc_bands_sharded(
        a, b, mesh, cu=16, me_range=8, lambda_satd=20.0))
    mv, mc = fn(cur, ref)
    mv, mc = np.asarray(mv), np.asarray(mc)
    if base_mv is None:
        base_mv, base_mc = mv, mc
        # sanity: the dominant integer MV matches the roll
        flat = mv.reshape(-1, 2)
        vals, counts = np.unique(flat, axis=0, return_counts=True)
        top = vals[np.argmax(counts)]
        # cur[y,x] = ref[y-3, x+2] -> mv = (dx, dy) = (2, -3) px
        assert tuple(top) == (8, -12), top   # qpel units
    else:
        assert np.array_equal(mv, base_mv), f"MVs differ at {n}-way"
        assert np.array_equal(mc, base_mc), f"MC differs at {n}-way"
    if n == 4:
        txt = fn.lower(cur, ref).compile().as_text()
        assert "collective-permute" in txt, "no ME halo collective"
print("P-HALO-OK")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.getcwd()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "P-HALO-OK" in r.stdout
