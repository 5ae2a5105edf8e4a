"""Differentiable vectorized BSDF library (four lobes, eval/sample/pdf).

Reimplements the reference's yocto-gl-derived BRDF set (Bxdf.cuh, which
credits https://github.com/xelatihy/yocto-gl yocto_shading.h) as batched,
autodiff-safe JAX. Lobes and selection policy (CudaUtil.cuh:248-270,284-334):

  opacity < 1-EPS  ?  (roughness < 1e-2 ? pure_refractive : refractive)
                   :  (roughness < 1e-2 ? reflective      : gltfpbr)

All functions take SoA arrays over a ray batch; every lane computes every
lobe NaN-free (masked lanes included) so gradients never see NaN * 0.

Conventions (same as reference):
- `wo` (outgoing) and `wi` (incoming) both point *away* from the surface.
- `frame.normal` is the shading normal flipped toward the viewer
  (SetNormal, CudaPrimitive.cuh:41-44); the refractive lobes reconstruct
  the true outward normal via front_face (Bxdf.cuh:238 etc.).
- eval_* returns BSDF x |cos(n, wi)| ("brdfcos"), exactly like the
  reference's eval functions which fold the cosine in.
"""

from __future__ import annotations

import jax.numpy as jnp

from pathtrace_tpu.models.scene import Material
from pathtrace_tpu.utils import math3
from pathtrace_tpu.utils.math3 import EPS, dot, normalize, reflect, refract, safe_sqrt
from pathtrace_tpu.utils.pytree import pytree_dataclass

PI = 3.141592
INV_PI = 1.0 / PI

LOBE_GLTFPBR = 0
LOBE_REFLECTIVE = 1
LOBE_REFRACTIVE = 2
LOBE_PURE_REFRACTIVE = 3
NUM_LOBES = 4


@pytree_dataclass
class ShadeFrame:
    """Local shading frame at a batch of hit points."""

    normal: jnp.ndarray      # (R,3) flipped toward viewer
    tangent: jnp.ndarray     # (R,3)
    bitangent: jnp.ndarray   # (R,3)
    front_face: jnp.ndarray  # (R,) bool

    @property
    def outward_normal(self) -> jnp.ndarray:
        """Geometric-side normal: hitResult.normal un-flipped
        (Bxdf.cuh:238 `bFrontFace ? normal : -normal`)."""
        return jnp.where(self.front_face[:, None], self.normal, -self.normal)


def select_lobe(mat: Material) -> jnp.ndarray:
    """(R,) int lobe id per the reference's opacity/roughness policy."""
    transparent = mat.opacity < (1.0 - EPS)
    delta = mat.roughness < 1e-2
    return jnp.where(
        transparent,
        jnp.where(delta, LOBE_PURE_REFRACTIVE, LOBE_REFRACTIVE),
        jnp.where(delta, LOBE_REFLECTIVE, LOBE_GLTFPBR),
    ).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Fresnel / microfacet building blocks (Bxdf.cuh:49-158)
# ---------------------------------------------------------------------------

def eta_to_reflectivity(eta: jnp.ndarray) -> jnp.ndarray:
    return ((eta - 1.0) ** 2) / ((eta + 1.0) ** 2)


def reflectivity_to_eta(reflectivity: jnp.ndarray) -> jnp.ndarray:
    """(Bxdf.cuh:53-56); clamped to 0.99 like the reference."""
    r = jnp.clip(reflectivity, 0.0, 0.99)
    sr = safe_sqrt(r)
    return (1.0 + sr) / (1.0 - sr)


def ior_from_specular(specular: jnp.ndarray) -> jnp.ndarray:
    """(R,) scalar IOR: reflectivity_to_eta(specular)[0]
    (CudaUtil.cuh:231 uses channel x only)."""
    return reflectivity_to_eta(specular[..., 0])


def fresnel_dielectric(eta: jnp.ndarray, normal: jnp.ndarray,
                       outgoing: jnp.ndarray) -> jnp.ndarray:
    """(R,) dielectric Fresnel (Bxdf.cuh:59-79). eta is per-lane (R,)."""
    cosw = jnp.abs(dot(normal, outgoing))
    sin2 = 1.0 - cosw * cosw
    eta2 = eta * eta
    cos2t = 1.0 - sin2 / jnp.maximum(eta2, math3.TINY)
    tir = cos2t < 0.0
    t0 = safe_sqrt(cos2t)
    t1 = eta * t0
    t2 = eta * cosw
    rs = math3.safe_div(cosw - t1, cosw + t1)
    rp = math3.safe_div(t0 - t2, t0 + t2)
    f = (rs * rs + rp * rp) / 2.0
    return jnp.where(tir, 1.0, f)


def fresnel_schlick(specular: jnp.ndarray, normal: jnp.ndarray,
                    outgoing: jnp.ndarray) -> jnp.ndarray:
    """(R,3) Schlick (Bxdf.cuh:81-87), including the zero-specular early-out."""
    cosine = dot(normal, outgoing, keepdims=True)
    pow5 = jnp.clip(1.0 - jnp.abs(cosine), EPS, 0.999) ** 5.0
    f = specular + (1.0 - specular) * pow5
    zero = math3.squared_length(specular, keepdims=True) < EPS
    return jnp.where(zero, 0.0, f)


def microfacet_distribution(roughness: jnp.ndarray, normal: jnp.ndarray,
                            halfway: jnp.ndarray) -> jnp.ndarray:
    """GGX NDF with the reference's 1e-2 divisor clamp (Bxdf.cuh:89-106)."""
    cosine = dot(normal, halfway)
    r2 = roughness * roughness
    c2 = cosine * cosine
    divisor = jnp.maximum(c2 * r2 + 1.0 - c2, 1e-2)
    d = r2 / (PI * divisor * divisor)
    return jnp.where(cosine <= EPS, 0.0, d)


def microfacet_shadowing1(roughness: jnp.ndarray, normal: jnp.ndarray,
                          halfway: jnp.ndarray, direction: jnp.ndarray) -> jnp.ndarray:
    """Smith GGX single-direction term (Bxdf.cuh:109-129, ggx branch)."""
    cosine = dot(normal, direction)
    cosineh = dot(halfway, direction)
    c2 = cosine * cosine
    r2 = roughness * roughness
    denom = jnp.abs(cosine) + safe_sqrt(c2 - r2 * c2 + r2)
    g = 2.0 * jnp.abs(cosine) / jnp.maximum(denom, math3.TINY)
    return jnp.where(cosine * cosineh <= 0.0, 0.0, g)


def microfacet_shadowing(roughness, normal, halfway, outgoing, incoming):
    return (microfacet_shadowing1(roughness, normal, halfway, outgoing)
            * microfacet_shadowing1(roughness, normal, halfway, incoming))


def sample_microfacet(roughness: jnp.ndarray, frame: ShadeFrame,
                      u_phi: jnp.ndarray, u_ry: jnp.ndarray) -> jnp.ndarray:
    """GGX halfway sample in the shading frame (Bxdf.cuh:140-150)."""
    phi = 2.0 * PI * u_phi
    ry = jnp.clip(u_ry, 0.0, 1.0 - 1e-6)
    theta = jnp.arctan(roughness * safe_sqrt(ry / (1.0 - ry)))
    st, ct = jnp.sin(theta), jnp.cos(theta)
    local = jnp.stack([jnp.cos(phi) * st, jnp.sin(phi) * st, ct], axis=-1)
    return (local[:, 0:1] * frame.tangent + local[:, 1:2] * frame.bitangent
            + local[:, 2:3] * frame.normal)


def sample_microfacet_pdf(roughness: jnp.ndarray, frame: ShadeFrame,
                          halfway: jnp.ndarray) -> jnp.ndarray:
    """(Bxdf.cuh:153-158): D * cos, zero below horizon."""
    cosine = dot(frame.normal, halfway)
    pdf = microfacet_distribution(roughness, frame.normal, halfway) * cosine
    return jnp.where(cosine < 0.0, 0.0, pdf)


def sample_hemisphere_cosine(frame: ShadeFrame, u_phi: jnp.ndarray,
                             u_ct: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted hemisphere in the shading frame (Bxdf.cuh:23-41)."""
    phi = 2.0 * PI * u_phi
    ct = safe_sqrt(u_ct)
    st = safe_sqrt(1.0 - ct * ct)
    x = jnp.cos(phi) * st
    y = jnp.sin(phi) * st
    return normalize(x[:, None] * frame.tangent + y[:, None] * frame.bitangent
                     + ct[:, None] * frame.normal)


def sample_hemisphere_uniform(frame: ShadeFrame, u_phi: jnp.ndarray,
                              u_ct: jnp.ndarray) -> jnp.ndarray:
    """Uniform hemisphere sampling - the reference's committed A/B against
    cosine weighting (Bxdf.cuh:23-41 SampleHemisphere;
    Img/Render/64sppWithUniformSampling.png vs 64sppWithCosineSampling.png).
    cos(theta) = u uniform in [0,1); pdf = 1/(2*pi)."""
    phi = 2.0 * PI * u_phi
    ct = u_ct
    st = safe_sqrt(1.0 - ct * ct)
    x = jnp.cos(phi) * st
    y = jnp.sin(phi) * st
    return normalize(x[:, None] * frame.tangent + y[:, None] * frame.bitangent
                     + ct[:, None] * frame.normal)


# ---------------------------------------------------------------------------
# Lobe 0: gltfpbr (Bxdf.cuh:160-207)
# ---------------------------------------------------------------------------

def eval_gltfpbr(mat: Material, frame: ShadeFrame, wo, wi) -> jnp.ndarray:
    n = frame.normal
    same_hemi = dot(n, wi) * dot(n, wo) > 0.0
    reflectivity = math3.lerp(mat.specular, mat.albedo, mat.metallic[:, None])
    f1 = fresnel_schlick(reflectivity, n, wo)
    halfway = normalize(wi + wo)
    f = fresnel_schlick(reflectivity, halfway, wi)
    d = microfacet_distribution(mat.roughness, n, halfway)
    g = microfacet_shadowing(mat.roughness, n, halfway, wo, wi)
    k = (1.0 - mat.metallic[:, None]) * (1.0 - f1)
    abs_cos_wi = jnp.abs(dot(n, wi, keepdims=True))
    denom = 4.0 * dot(n, wo, keepdims=True) * dot(n, wi, keepdims=True)
    spec = f * (d * g)[:, None] * math3.safe_div(abs_cos_wi, denom)
    diffuse = mat.albedo * k * INV_PI * abs_cos_wi
    return jnp.where(same_hemi[:, None], diffuse + spec, 0.0)


def sample_gltfpbr(mat: Material, frame: ShadeFrame, wo,
                   u_lobe, u_phi, u_ry, uniform_hemi: bool = False
                   ) -> jnp.ndarray:
    """(Bxdf.cuh:179-194). Returns wi; zero vector = dead sample (the
    reference returns {0,0,0} when the microfacet reflection lands in the
    wrong hemisphere, which kills the path upstream, CudaUtil.cuh:335-338).

    uniform_hemi reproduces the reference's uniform-vs-cosine hemisphere
    A/B (Bxdf.cuh:23-41; Img/Render/64sppWith*Sampling.png) for the
    diffuse branch; the pdf switches to 1/(2*pi) to keep the estimator
    unbiased (higher variance, same converged image)."""
    n = frame.normal
    reflectivity = math3.lerp(mat.specular, mat.albedo, mat.metallic[:, None])
    f_mean = math3.mean3(fresnel_schlick(reflectivity, n, wo))
    pick_spec = u_lobe < f_mean

    halfway = sample_microfacet(mat.roughness, frame, u_phi, u_ry)
    wi_spec = reflect(wo, halfway)
    bad = dot(n, wi_spec) * dot(n, wo) < -EPS
    wi_spec = jnp.where(bad[:, None], 0.0, wi_spec)

    if uniform_hemi:
        wi_diff = sample_hemisphere_uniform(frame, u_phi, u_ry)
    else:
        wi_diff = sample_hemisphere_cosine(frame, u_phi, u_ry)
    return jnp.where(pick_spec[:, None], wi_spec, wi_diff)


def pdf_gltfpbr(mat: Material, frame: ShadeFrame, wo, wi,
                uniform_hemi: bool = False) -> jnp.ndarray:
    n = frame.normal
    same_hemi = dot(n, wi) * dot(n, wo) > 0.0
    halfway = normalize(wo + wi)
    reflectivity = math3.lerp(mat.specular, mat.albedo, mat.metallic[:, None])
    f = math3.mean3(fresnel_schlick(reflectivity, n, wo))
    pdf_spec = math3.safe_div(
        sample_microfacet_pdf(mat.roughness, frame, halfway),
        4.0 * jnp.abs(dot(wo, halfway)))
    if uniform_hemi:
        pdf_diff = jnp.full(wo.shape[:-1], 0.5 * INV_PI)
    else:
        pdf_diff = dot(n, wi) * INV_PI
    pdf = f * pdf_spec + (1.0 - f) * pdf_diff
    return jnp.where(same_hemi, pdf, 0.0)


# ---------------------------------------------------------------------------
# Lobe 1: delta reflective (Bxdf.cuh:211-234)
# ---------------------------------------------------------------------------

def eval_reflective(mat: Material, frame: ShadeFrame, wo, wi) -> jnp.ndarray:
    n = frame.normal
    same_hemi = dot(n, wi) * dot(n, wo) > 0.0
    reflectivity = math3.lerp(mat.specular, mat.albedo, mat.metallic[:, None])
    f1 = fresnel_schlick(reflectivity, n, wo)
    f = fresnel_schlick(reflectivity, n, wi)
    k = (1.0 - mat.metallic[:, None]) * (1.0 - f1)
    abs_cos_wi = jnp.abs(dot(n, wi, keepdims=True))
    val = mat.albedo * k * INV_PI * abs_cos_wi + f * abs_cos_wi
    return jnp.where(same_hemi[:, None], val, 0.0)


def sample_reflective(mat: Material, frame: ShadeFrame, wo) -> jnp.ndarray:
    return reflect(wo, frame.normal)


def pdf_reflective(mat: Material, frame: ShadeFrame, wo, wi) -> jnp.ndarray:
    return jnp.ones(wo.shape[:-1], jnp.float32)


# ---------------------------------------------------------------------------
# Lobe 2: rough refractive (Walter 2007; Bxdf.cuh:236-315)
# ---------------------------------------------------------------------------

def _refractive_setup(mat: Material, frame: ShadeFrame, wo):
    normal = frame.outward_normal
    entering = dot(normal, wo) >= 0.0
    up_normal = jnp.where(entering[:, None], normal, -normal)
    ior = ior_from_specular(mat.specular)
    rel_ior = jnp.where(entering, ior, 1.0 / jnp.maximum(ior, math3.TINY))
    return normal, entering, up_normal, ior, rel_ior


def _walter_halfway(rel_ior, entering, wi, wo):
    """halfway = -normalize(rel_ior*wi + wo) * (entering ? 1 : -1)."""
    h = -normalize(rel_ior[:, None] * wi + wo)
    return jnp.where(entering[:, None], h, -h)


def eval_refractive(mat: Material, frame: ShadeFrame, wo, wi) -> jnp.ndarray:
    normal, entering, up_normal, _, rel_ior = _refractive_setup(mat, frame, wo)
    reflecting = dot(normal, wi) * dot(normal, wo) >= 0.0
    abs_cos_wi = jnp.abs(dot(normal, wi))

    # reflection branch
    h_r = normalize(wi + wo)
    f_r = fresnel_dielectric(rel_ior, h_r, wo)
    d_r = microfacet_distribution(mat.roughness, up_normal, h_r)
    g_r = microfacet_shadowing(mat.roughness, up_normal, h_r, wo, wi)
    denom_r = jnp.abs(4.0 * dot(normal, wo) * dot(normal, wi))
    val_r = f_r * d_r * g_r * math3.safe_div(abs_cos_wi, denom_r)

    # transmission branch (Walter 2007 eq. 21)
    h_t = _walter_halfway(rel_ior, entering, wi, wo)
    f_t = fresnel_dielectric(rel_ior, h_t, wo)
    d_t = microfacet_distribution(mat.roughness, up_normal, h_t)
    g_t = microfacet_shadowing(mat.roughness, up_normal, h_t, wo, wi)
    jac_num = dot(wo, h_t) * dot(wi, h_t)
    jac_den = dot(wo, normal) * dot(wi, normal)
    denom_t = (rel_ior * dot(h_t, wi) + dot(h_t, wo)) ** 2
    val_t = (jnp.abs(math3.safe_div(jac_num, jac_den))
             * (1.0 - f_t) * d_t * g_t * math3.safe_div(abs_cos_wi, denom_t))

    scalar = jnp.where(reflecting, val_r, val_t)
    return mat.albedo * scalar[:, None]


def sample_refractive(mat: Material, frame: ShadeFrame, wo,
                      u_lobe, u_phi, u_ry) -> jnp.ndarray:
    """(Bxdf.cuh:271-288). Zero vector on hemisphere-check failure."""
    normal, entering, up_normal, ior, rel_ior = _refractive_setup(mat, frame, wo)
    halfway = sample_microfacet(mat.roughness, frame, u_phi, u_ry)
    f = fresnel_dielectric(rel_ior, halfway, wo)
    pick_reflect = u_lobe < f

    wi_r = reflect(wo, halfway)
    bad_r = ~(dot(normal, wo) * dot(normal, wi_r) >= 0.0)
    wi_r = jnp.where(bad_r[:, None], 0.0, wi_r)

    inv_eta = jnp.where(entering, 1.0 / jnp.maximum(ior, math3.TINY), ior)
    wi_t = refract(wo, halfway, inv_eta)
    bad_t = dot(normal, wo) * dot(normal, wi_t) >= 0.0
    wi_t = jnp.where(bad_t[:, None], 0.0, wi_t)

    return jnp.where(pick_reflect[:, None], wi_r, wi_t)


def pdf_refractive(mat: Material, frame: ShadeFrame, wo, wi) -> jnp.ndarray:
    normal, entering, up_normal, _, rel_ior = _refractive_setup(mat, frame, wo)
    reflecting = dot(normal, wi) * dot(normal, wo) >= 0.0

    h_r = normalize(wi + wo)
    pdf_r = (fresnel_dielectric(rel_ior, h_r, wo)
             * sample_microfacet_pdf(mat.roughness, frame, h_r)
             * math3.safe_div(jnp.ones_like(rel_ior),
                              4.0 * jnp.abs(dot(wo, h_r))))

    h_t = _walter_halfway(rel_ior, entering, wi, wo)
    denom_t = (rel_ior * dot(h_t, wi) + dot(h_t, wo)) ** 2
    pdf_t = ((1.0 - fresnel_dielectric(rel_ior, h_t, wo))
             * sample_microfacet_pdf(mat.roughness, frame, h_t)
             * math3.safe_div(jnp.abs(dot(h_t, wi)), denom_t))

    return jnp.where(reflecting, pdf_r, pdf_t)


# ---------------------------------------------------------------------------
# Lobe 3: delta refractive (Bxdf.cuh:317-370)
# ---------------------------------------------------------------------------

def eval_pure_refractive(mat: Material, frame: ShadeFrame, wo, wi) -> jnp.ndarray:
    normal, entering, up_normal, _, rel_ior = _refractive_setup(mat, frame, wo)
    reflecting = dot(normal, wi) * dot(normal, wo) >= 0.0

    h_r = normalize(wi + wo)
    f_r = fresnel_dielectric(rel_ior, h_r, wo)

    h_t = _walter_halfway(rel_ior, entering, wi, wo)
    f_t = fresnel_dielectric(rel_ior, h_t, wo)
    val_t = (1.0 - f_t) / jnp.maximum(rel_ior * rel_ior, math3.TINY)

    scalar = jnp.where(reflecting, f_r, val_t)
    return mat.albedo * scalar[:, None]


def sample_pure_refractive(mat: Material, frame: ShadeFrame, wo,
                           u_lobe) -> jnp.ndarray:
    normal, entering, up_normal, ior, rel_ior = _refractive_setup(mat, frame, wo)
    f = fresnel_dielectric(rel_ior, up_normal, wo)
    pick_reflect = u_lobe < f
    wi_r = reflect(wo, up_normal)
    inv_eta = jnp.where(entering, 1.0 / jnp.maximum(ior, math3.TINY), ior)
    wi_t = refract(wo, up_normal, inv_eta)
    return jnp.where(pick_reflect[:, None], wi_r, wi_t)


def pdf_pure_refractive(mat: Material, frame: ShadeFrame, wo, wi) -> jnp.ndarray:
    normal, entering, up_normal, _, rel_ior = _refractive_setup(mat, frame, wo)
    reflecting = dot(normal, wi) * dot(normal, wo) >= 0.0
    h_r = normalize(wi + wo)
    f_r = fresnel_dielectric(rel_ior, h_r, wo)
    h_t = _walter_halfway(rel_ior, entering, wi, wo)
    f_t = 1.0 - fresnel_dielectric(rel_ior, h_t, wo)
    return jnp.where(reflecting, f_r, f_t)


# ---------------------------------------------------------------------------
# Branchless dispatch over the four lobes (wavefront-friendly masked select;
# the lobe-sorted wavefront pipeline shades each lobe densely instead).
# Select chains, not stack+take_along_axis: nested where's stay dense
# elementwise selects that XLA fuses.
# ---------------------------------------------------------------------------

def _select4(lobe, v0, v1, v2, v3):
    if v0.ndim > lobe.ndim:
        lobe = lobe[:, None]
    return jnp.where(
        lobe == LOBE_GLTFPBR, v0,
        jnp.where(lobe == LOBE_REFLECTIVE, v1,
                  jnp.where(lobe == LOBE_REFRACTIVE, v2, v3)))


def eval_bsdfcos(mat: Material, frame: ShadeFrame, wo, wi) -> jnp.ndarray:
    lobe = select_lobe(mat)
    return _select4(
        lobe,
        eval_gltfpbr(mat, frame, wo, wi),
        eval_reflective(mat, frame, wo, wi),
        eval_refractive(mat, frame, wo, wi),
        eval_pure_refractive(mat, frame, wo, wi))


def sample_bsdf(mat: Material, frame: ShadeFrame, wo,
                u_lobe, u_phi, u_ry, uniform_hemi: bool = False
                ) -> jnp.ndarray:
    lobe = select_lobe(mat)
    return _select4(
        lobe,
        sample_gltfpbr(mat, frame, wo, u_lobe, u_phi, u_ry, uniform_hemi),
        sample_reflective(mat, frame, wo),
        sample_refractive(mat, frame, wo, u_lobe, u_phi, u_ry),
        sample_pure_refractive(mat, frame, wo, u_lobe))


def pdf_bsdf(mat: Material, frame: ShadeFrame, wo, wi,
             uniform_hemi: bool = False) -> jnp.ndarray:
    lobe = select_lobe(mat)
    return _select4(
        lobe,
        pdf_gltfpbr(mat, frame, wo, wi, uniform_hemi),
        pdf_reflective(mat, frame, wo, wi),
        pdf_refractive(mat, frame, wo, wi),
        pdf_pure_refractive(mat, frame, wo, wi))
