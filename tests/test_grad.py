"""Gradient oracle tests: autodiff vs central finite differences on the
same deterministic estimator (north star: allclose; SURVEY.md §4)."""

import numpy as np
import pytest

from pathtrace_tpu.diff import fd_material_grad, material_grads
from pathtrace_tpu.integrator.config import IntegratorConfig
from pathtrace_tpu.models import procedural
from pathtrace_tpu.utils import rng

# FD-comparison config:
# - Russian roulette off (rr_bounce >= max_bounce): RR survival depends on
#   the path weight, hence on the perturbed material; a finite difference
#   sees discrete survival flips as O(1/h) spikes.
# - detach_sampling off: FD perturbs the SAME fixed random seeds, so it
#   differentiates *through* the sampler (roughness moves the sampled
#   microfacet direction). That is exactly the reparameterized estimator;
#   the detached estimator agrees with it only in expectation over
#   samples, not realization-by-realization.
# Default renders keep detach_sampling=True (robust optimization); both
# estimators' primal values are identical.
FD_CFG = IntegratorConfig(rr_bounce=99, detach_sampling=False)


@pytest.fixture(scope="module")
def setup():
    scene = procedural.cornell_box_scene()
    cam = procedural.default_camera(16, 16)
    key = rng.make_key(0)
    spp = 4
    g_tri, g_sph, loss = material_grads(scene, cam, spp, key, cfg=FD_CFG)
    return scene, cam, key, spp, g_tri, g_sph, loss


def _check(ad, fd, label, tol=2e-2):
    denom = max(abs(fd), abs(ad), 1.0)
    rel = abs(ad - fd) / denom
    assert rel < tol, f"{label}: ad={ad} fd={fd} rel={rel}"


def test_grads_finite(setup):
    _, _, _, _, g_tri, g_sph, loss = setup
    assert np.isfinite(float(loss))
    for f in ("albedo", "emittance", "roughness", "specular", "metallic"):
        assert np.isfinite(np.asarray(getattr(g_tri, f))).all(), f


def test_albedo_grad_matches_fd(setup):
    scene, cam, key, spp, g_tri, _, _ = setup
    # a floor triangle's red albedo channel (floor = first two tris)
    idx = (0, 0)
    fd = fd_material_grad(scene, cam, spp, key, "tris", "albedo", idx, h=2e-2, cfg=FD_CFG)
    ad = float(np.asarray(g_tri.albedo)[idx])
    _check(ad, fd, "albedo[0,0]")


def test_emittance_grad_matches_fd(setup):
    scene, cam, key, spp, g_tri, _, _ = setup
    light_idx = int(np.asarray(scene.lights)[0])
    idx = (light_idx, 1)
    fd = fd_material_grad(scene, cam, spp, key, "tris", "emittance", idx,
                          h=5e-2, cfg=FD_CFG)
    ad = float(np.asarray(g_tri.emittance)[idx])
    assert ad > 0.0, "more emission must brighten the image"
    _check(ad, fd, "emittance[light,1]")


def test_roughness_grad_matches_fd(setup):
    """Roughness has the strongest finite-h FD artifacts (the sampled
    microfacet direction moves with theta, so large h crosses discrete
    accept/reject boundaries): convergence study shows FD -> AD as h -> 0
    (h=1e-2: -1.09, h=1e-3: -1.22, AD: -1.19 on this config), so compare
    at h=1e-2 with a tolerance sized to the observed FD error."""
    scene, cam, key, spp, g_tri, _, _ = setup
    fd = fd_material_grad(scene, cam, spp, key, "tris", "roughness", (2,),
                          h=1e-2, cfg=FD_CFG)
    ad = float(np.asarray(g_tri.roughness)[2])
    _check(ad, fd, "roughness[2]", tol=0.15)


def test_specular_grad_matches_fd(setup):
    """specular drives IOR via reflectivity_to_eta (CudaUtil.cuh:231), so
    this is the IOR-gradient path."""
    scene, cam, key, spp, g_tri, _, _ = setup
    fd = fd_material_grad(scene, cam, spp, key, "tris", "specular", (4, 0),
                          h=1e-2, cfg=FD_CFG)
    ad = float(np.asarray(g_tri.specular)[(4, 0)])
    _check(ad, fd, "specular[4,0]")


def test_sphere_material_grads():
    """IOR/roughness grads through analytic spheres (glass scene)."""
    scene = procedural.glass_scene()
    cam = procedural.default_camera(12, 12)
    key = rng.make_key(1)
    spp = 4
    g_tri, g_sph, _ = material_grads(scene, cam, spp, key, cfg=FD_CFG)
    assert np.isfinite(np.asarray(g_sph.albedo)).all()
    assert np.isfinite(np.asarray(g_sph.roughness)).all()
    assert np.isfinite(np.asarray(g_sph.specular)).all()
    # FD itself varies ~1.6% across h on this config (multi-bounce glass
    # paths amplify float reordering); 3% tolerance.
    fd = fd_material_grad(scene, cam, spp, key, "spheres", "albedo", (0, 0),
                          h=2e-2, cfg=FD_CFG)
    ad = float(np.asarray(g_sph.albedo)[(0, 0)])
    _check(ad, fd, "sphere albedo[0,0]", tol=3e-2)


def test_rr_on_grads_finite_and_consistent():
    """With RR enabled (default config) gradients stay finite and agree
    in sign/magnitude-order with the RR-off gradient."""
    scene = procedural.cornell_box_scene()
    cam = procedural.default_camera(12, 12)
    key = rng.make_key(2)
    g_on, _, _ = material_grads(scene, cam, 4, key)
    g_off, _, _ = material_grads(scene, cam, 4, key, cfg=FD_CFG)
    a_on = float(np.asarray(g_on.albedo)[0, 0])
    a_off = float(np.asarray(g_off.albedo)[0, 0])
    assert np.isfinite(a_on) and np.isfinite(a_off)
    assert a_on > 0 and a_off > 0
    assert 0.3 < a_on / a_off < 3.0


def test_remat_grads_match():
    """Rematerialized backward (jax.checkpoint on the bounce scan) must
    reproduce the stored-activation gradients exactly - counter-based RNG
    replays the identical sample stream during recompute."""
    import dataclasses
    scene = procedural.cornell_box_scene()
    cam = procedural.default_camera(12, 12)
    key = rng.make_key(4)
    g_std, _, loss_std = material_grads(scene, cam, 2, key, cfg=FD_CFG)
    cfg_r = dataclasses.replace(FD_CFG, remat=True)
    g_rmt, _, loss_rmt = material_grads(scene, cam, 2, key, cfg=cfg_r)
    np.testing.assert_allclose(float(loss_std), float(loss_rmt), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g_std.albedo),
                               np.asarray(g_rmt.albedo), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(g_std.roughness),
                               np.asarray(g_rmt.roughness), rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# north-star 1e-3 oracle: frozen-sampling FD (production detached contract)
# ---------------------------------------------------------------------------

PROD_CFG = IntegratorConfig(rr_bounce=99, detach_sampling=True)


@pytest.fixture(scope="module")
def frozen_setup():
    from pathtrace_tpu.diff.fd import make_frozen_sampler
    scene = procedural.cornell_box_scene(include_spheres=True).with_mt()
    cam = procedural.default_camera(16, 16)
    key = rng.make_key(0)
    spp = 4
    g_tri, g_sph, _ = material_grads(scene, cam, spp, key, cfg=PROD_CFG)
    return scene, cam, key, spp, g_tri, g_sph, make_frozen_sampler(scene)


@pytest.mark.parametrize("target,field,idx,h", [
    ("tris", "albedo", (0, 0), 1e-2),
    ("tris", "roughness", (2,), 2e-3),
    ("tris", "specular", (4, 0), 2e-3),
    ("spheres", "albedo", (0, 0), 1e-2),
    ("spheres", "roughness", (0,), 2e-3),
])
def test_frozen_fd_matches_production_grad(frozen_setup, target, field,
                                           idx, h):
    """Central differences with the sampling-side materials FROZEN at the
    base values measure exactly the production (detach_sampling)
    derivative - no O(1/h) discrete-flip terms - so the north-star 1e-3
    holds even on the chaotic sphere transport. The committed
    gradcheck_r03.json pins the full sweep at higher spp."""
    scene, cam, key, spp, g_tri, g_sph, frozen = frozen_setup
    fd = fd_material_grad(scene, cam, spp, key, target, field, idx, h=h,
                          cfg=PROD_CFG, sample_mat_fn=frozen)
    g = g_tri if target == "tris" else g_sph
    ad = float(np.asarray(getattr(g, field))[idx])
    _check(ad, fd, f"{target}.{field}{idx}", tol=1e-3)


def test_forward_reverse_ad_agree_sphere_scene():
    """Regression for the NEE shadow t_min=0 bug: a shadow ray leaving a
    sphere re-hit its own surface at t ~ +-1e-7 depending on rounding,
    so the borderline accept flipped between differently-compiled
    programs - the grad program's PRIMAL differed from the plain render
    by 1.6% and reverse-mode gradients disagreed with forward-mode by
    ~3%. With t_min = EPS both must agree to float noise."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from pathtrace_tpu.diff.grad import render_with_params

    scene = procedural.cornell_box_scene(include_spheres=True).with_mt()
    cam = procedural.default_camera(16, 16)
    key = rng.make_key(0)

    def loss(mat):
        return jnp.sum(render_with_params(scene, mat, scene.spheres.mat,
                                          cam, 4, key, PROD_CFG))

    v_plain = float(loss(scene.mat))
    tangent = jax.tree.map(jnp.zeros_like, scene.mat)
    light = int(np.asarray(scene.lights)[0])
    tangent = dataclasses.replace(
        tangent,
        emittance=jnp.zeros_like(scene.mat.emittance).at[light, 0].set(1.0))
    _, jv = jax.jvp(loss, (scene.mat,), (tangent,))
    v_grad, g = jax.value_and_grad(loss)(scene.mat)
    rev = float(np.asarray(g.emittance)[light, 0])

    assert abs(float(v_grad) - v_plain) < 1e-2 * abs(v_plain)
    _check(rev, float(jv), "emittance fwd-vs-rev", tol=1e-4)


def test_gradcheck_artifact_pinned():
    """The committed frozen-sampling oracle artifact must hold the
    north-star 1e-3 (regenerate with tools/gradcheck_oracle.py)."""
    import json
    import os
    path = os.path.join(os.path.dirname(__file__), "..",
                        "gradcheck_r03.json")
    with open(path) as f:
        report = json.load(f)
    assert report["pass"] is True
    assert report["max_rel_err"] <= 1e-3
    assert len(report["checks"]) >= 8

