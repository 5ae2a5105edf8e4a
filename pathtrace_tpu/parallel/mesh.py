"""Multi-device scaling: rays/tiles sharded over a device mesh.

The reference is strictly single-GPU (SURVEY.md §2: its only parallelism is
one CUDA thread per pixel); this module adds scaling over several GPUs:

- a 1-D `jax.sharding.Mesh` over all devices (cards of one host are
  joined all to all, so the mesh follows the pixel split alone; several
  hosts join through jax.distributed.initialize, see parallel/distributed)
- the pixel/ray batch is sharded on the mesh axis; the scene (geometry,
  acceleration structure, materials) is replicated in every device's
  memory
- rendering needs NO communication (each device owns its pixels);
  gradient steps psum material gradients and the loss
- determinism: RNG streams are keyed by logical ray id (utils/rng.py), so
  an N-device render traces the same paths as the 1-device render

Collectives ride XLA (`psum`, lowered to NCCL on GPUs).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pathtrace_tpu.core.camera import Camera
from pathtrace_tpu.integrator.config import IntegratorConfig
from pathtrace_tpu.integrator.megakernel import trace_paths
from pathtrace_tpu.models.scene import Scene
from pathtrace_tpu.utils import rng
from pathtrace_tpu.utils.pytree import replace

RAY_AXIS = "rays"


def make_ray_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (RAY_AXIS,), devices=devices)


def _camera_rays(camera: Camera, sample_idx, base_key):
    px, py = camera.pixel_grid()
    num_pix = px.shape[0]
    pixel_ids = jnp.arange(num_pix, dtype=jnp.int32)
    ray_ids = sample_idx * num_pix + pixel_ids
    ju = rng.pixel_jitter(base_key, ray_ids)
    dirs = camera.ray_directions(px, py, ju[:, 0], ju[:, 1])
    org = jnp.broadcast_to(camera.pos, dirs.shape)
    return org, dirs, ray_ids


def _shard_trace(scene, org, dirs, ray_ids, base_key, cfg, spp, num_pix):
    """Body run per device shard: spp-scan of the bounce megakernel over
    the local slice of rays. Pure data parallel - no collectives.

    ray_ids hold the *global* pixel ids of this shard's slice; sample s
    uses id = s*num_pix + pixel_id (the reference's stream layout,
    pathtracer.cu:71), keeping RNG shard-invariant.
    """
    def body(accum, s):
        accum = accum + trace_paths(scene, org, dirs,
                                    ray_ids + s * num_pix, base_key, cfg)
        return accum, None

    accum = jnp.zeros((org.shape[0], 3), jnp.float32)
    accum, _ = jax.lax.scan(body, accum, jnp.arange(spp))
    return accum / spp


@partial(jax.jit, static_argnames=("spp", "cfg", "mesh"))
def render_sharded(scene: Scene, camera: Camera, spp: int, base_key,
                   mesh: Mesh, cfg: IntegratorConfig = IntegratorConfig()):
    """(H, W, 3) linear image; pixels sharded over the mesh axis.

    Requires W*H divisible by the mesh size (standard tile padding
    constraint; all preset configs satisfy it).
    """
    num_pix = camera.width * camera.height
    n_dev = mesh.devices.size
    assert num_pix % n_dev == 0, (num_pix, n_dev)

    org, dirs, ray_ids = _camera_rays(camera, 0, base_key)

    traced = jax.shard_map(
        lambda sc, o, d, ids: _shard_trace(sc, o, d, ids, base_key, cfg, spp,
                                           num_pix),
        mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
        check_vma=False,  # while_loop carries start as replicated constants
    )
    img = traced(scene, org, dirs, ray_ids)
    return img.reshape(camera.height, camera.width, 3)


@partial(jax.jit, static_argnames=("spp", "cfg", "mesh"))
def render_grad_sharded(scene: Scene, camera: Camera, target: jnp.ndarray,
                        spp: int, base_key, mesh: Mesh,
                        cfg: IntegratorConfig = IntegratorConfig()):
    """One distributed "training step" against a target image.

    Returns (loss, (tri_mat_grads, sphere_mat_grads)). Inside shard_map each
    device differentiates its local L2 tile loss w.r.t. the replicated
    material pytree, then grads and loss are `psum`ed. This is the
    renderer analog of data-parallel training with replicated parameters.
    """
    num_pix = camera.width * camera.height
    n_dev = mesh.devices.size
    assert num_pix % n_dev == 0

    org, dirs, ray_ids = _camera_rays(camera, 0, base_key)
    target_flat = target.reshape(num_pix, 3)

    def local_step(scene_in, o, d, ids, tgt):
        def loss_fn(tri_mat, sph_mat):
            sc = replace(scene_in, mat=tri_mat,
                         spheres=replace(scene_in.spheres, mat=sph_mat))
            img = _shard_trace(sc, o, d, ids, base_key, cfg, spp, num_pix)
            return jnp.sum((img - tgt) ** 2)

        loss, grads = jax.value_and_grad(loss_fn, argnums=(0, 1))(
            scene_in.mat, scene_in.spheres.mat)
        loss = jax.lax.psum(loss, RAY_AXIS)
        grads = jax.lax.psum(grads, RAY_AXIS)
        return loss, grads

    stepped = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return stepped(scene, org, dirs, ray_ids, target_flat)


@partial(jax.jit, static_argnames=("cfg", "mesh", "lanes"))
def render_wavefront_sharded(scene: Scene, camera: Camera, spp, base_key,
                             mesh: Mesh,
                             cfg: IntegratorConfig = IntegratorConfig(),
                             lanes: int = 65536, sample_offset=0):
    """The PRODUCTION engine (wavefront with path regeneration,
    integrator/wavefront.py) sharded over the mesh: each device owns a
    contiguous pixel slice and a private lane pool, regenerating paths
    from its own slice of the pixel*sample pool. RNG streams are keyed by
    GLOBAL path id, so the N-device image equals the 1-device image up to
    film float-sum reordering. No communication except the rays-count
    psum. spp/sample_offset may be traced (one program, chunked launches).

    Returns ((H, W, 3) image, total rays traced across devices).
    """
    from pathtrace_tpu.integrator.wavefront import _run_wavefront

    num_pix = camera.width * camera.height
    n_dev = mesh.devices.size
    assert num_pix % n_dev == 0, (num_pix, n_dev)
    assert lanes % n_dev == 0, (lanes, n_dev)
    np_local = num_pix // n_dev
    lanes_local = lanes // n_dev

    def shard_body(sc):
        i = jax.lax.axis_index(RAY_AXIS)
        film, nrays = _run_wavefront(
            sc, camera, spp, base_key, cfg, lanes_local,
            sample_offset=sample_offset, pix_offset=i * np_local,
            num_pix_local=np_local, num_pix_total=num_pix)
        return film, jax.lax.psum(nrays[None], RAY_AXIS)

    film, rays = jax.shard_map(
        shard_body, mesh=mesh, in_specs=(P(),),
        out_specs=(P(RAY_AXIS), P()), check_vma=False)(scene)
    return film.reshape(camera.height, camera.width, 3), rays[0]


@partial(jax.jit, static_argnames=("spp", "cfg", "mesh"))
def train_step_replay_sharded(scene: Scene, camera: Camera, target, spp: int,
                              base_key, mesh: Mesh,
                              cfg: IntegratorConfig = IntegratorConfig()):
    """One distributed training step on the PRODUCTION backward: L2 image
    loss differentiated via the compact path-record replay (diff/replay),
    sharded over pixel slices with psum'd loss and material grads.

    Per device: (1) recorded forward over its pixel slice -> image tile,
    (2) L2 cotangent 2*(img - target), (3) record/replay VJP per sample
    (O(R) residuals, zero intersection searches in the backward graph).
    Returns (loss, (tri_mat_grads, sphere_mat_grads), full image).
    """
    from pathtrace_tpu.diff.replay import (_camera_rays,
                                           _material_grads_replay_impl,
                                           record_paths)

    num_pix = camera.width * camera.height
    n_dev = mesh.devices.size
    assert num_pix % n_dev == 0, (num_pix, n_dev)
    np_local = num_pix // n_dev
    target_flat = target.reshape(num_pix, 3)

    def local_step(sc, tgt):
        i = jax.lax.axis_index(RAY_AXIS)
        pix0 = i * np_local

        # plain recorded forward (primal only; the unused tape is DCE'd)
        # to get the L2 cotangent; the replay VJP then uses it as a fixed
        # weight (recorded primal == replay primal to ~1e-5)
        def fwd(accum, s):
            org, dirs, ray_ids = _camera_rays(sc, camera, s, base_key,
                                              pix0, np_local)
            rad, _ = record_paths(sc, org, dirs, ray_ids, base_key, cfg)
            return accum + rad, None

        accum, _ = jax.lax.scan(fwd, jnp.zeros((np_local, 3), jnp.float32),
                                jnp.arange(spp))
        img0 = accum / spp
        ct = 2.0 * (img0 - tgt)
        g_tri, g_sph, img = _material_grads_replay_impl(
            sc, camera, spp, base_key, cfg, ct,
            pix_offset=pix0, num_pix_local=np_local)
        loss = jax.lax.psum(jnp.sum((img - tgt) ** 2), RAY_AXIS)
        grads = jax.lax.psum((g_tri, g_sph), RAY_AXIS)
        return loss, grads, img

    loss, grads, img = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(RAY_AXIS)),
        out_specs=(P(), P(), P(RAY_AXIS)),
        check_vma=False)(scene, target_flat)
    return loss, grads, img.reshape(camera.height, camera.width, 3)


def train_step_wavetape_sharded(scene: Scene, camera: Camera, target,
                                spp: int, base_key, mesh: Mesh,
                                cfg: IntegratorConfig = IntegratorConfig(),
                                lanes: int = 65536, chunk: int = 65536):
    """One distributed training step on the wavefront-taped backward
    (diff/wavetape): L2 image loss, pixel-slice sharding, psum'd loss and
    material grads.

    Per device: (1) ONE wavefront recording sweep over its pixel slice's
    whole path pool (records + recorded-primal film in the same pass),
    (2) L2 cotangent 2*(film - target)/spp from the recorded primal
    (== replay primal to XLA fusion reassociation; the 1/spp is the
    per-sample share wavetape_grads_core expects), (3) length-bucketed
    chunked replay VJPs. RNG/camera rays keyed by GLOBAL path ids, so
    the N-device step is path-for-path identical to 1-device.
    Returns (loss, (tri_mat_grads, sphere_mat_grads), full image).
    Not jitted here (meshes don't hash into a stable jit key across
    sizes); wrap the call in jax.jit with mesh/spp/cfg closed over for
    repeated stepping, as chip_smoke.py does.
    """
    from pathtrace_tpu.diff.wavetape import wavetape_grads_core

    num_pix = camera.width * camera.height
    n_dev = mesh.devices.size
    assert num_pix % n_dev == 0, (num_pix, n_dev)
    np_local = num_pix // n_dev
    target_flat = target.reshape(num_pix, 3)

    def local_step(sc, tgt):
        i = jax.lax.axis_index(RAY_AXIS)
        pix0 = i * np_local

        # ONE recording pass: the L2 cotangent comes from the recorded
        # primal film via ct_fn (== replay primal to fusion noise)
        g_tri, g_sph, film, _ = wavetape_grads_core(
            sc, camera, spp, base_key, cfg, None, lanes, chunk,
            pix_offset=pix0, num_pix_local=np_local,
            num_pix_total=num_pix,
            ct_fn=lambda f0: 2.0 * (f0 - tgt) / spp)
        loss = jax.lax.psum(jnp.sum((film - tgt) ** 2), RAY_AXIS)
        grads = jax.lax.psum((g_tri, g_sph), RAY_AXIS)
        return loss, grads, film

    loss, grads, img = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(RAY_AXIS)),
        out_specs=(P(), P(), P(RAY_AXIS)),
        check_vma=False)(scene, target_flat)
    return loss, grads, img.reshape(camera.height, camera.width, 3)
