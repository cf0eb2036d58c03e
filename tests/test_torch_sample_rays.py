"""The sampler wrapper's contract on the CPU (render/sample_kernels.py).

On CPU tensors ``sample_rays`` runs its plain version, launches nothing,
and hands the visibility query and the splat what occlusion_inputs and
splat_inputs give them; inputs of the wrong dtype, shape or layout raise.
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""

import pytest
import torch

import nlos_surface_optimization_torch as pt
from nlos_surface_optimization_torch.geometry.mesh import face_normals_areas
from nlos_surface_optimization_torch.geometry.sampling import (
    stratified_barycoords,
)
from nlos_surface_optimization_torch.render import core
from nlos_surface_optimization_torch.render import sample_kernels as sk

torch.set_num_threads(1)


def _scene(bumpy_mesh, normal):
    """The bumpy mesh with a zero-area face and two padding faces
    (f_valid False), 'vn' normals where asked; 9 sources, the last a
    zero-normal padding source."""
    v, f = bumpy_mesh
    f = f.copy()
    f[3, 1] = f[3, 0]
    mesh = pt.make_mesh(v, f, device="cpu", pad_f=f.shape[0] + 2)
    if normal == "vn":
        mesh = mesh._replace(vn=pt.vertex_normals(mesh.v, mesh.f,
                                                  mesh.f_valid))
    lighting, lnormal = (torch.from_numpy(x) for x in
                         pt.make_confocal_scan(3))
    lnormal[-1] = 0.0
    return mesh, lighting, lnormal


def _fields(c):
    return dict(c.rays._asdict(), o=c.o, t_self=c.t_self, fid=c.fid,
                contrib=c.contrib, bin_f=c.bin_f)


@pytest.mark.parametrize("contrib", [False, True])
@pytest.mark.parametrize("normal", ["fn", "vn"])
@pytest.mark.parametrize("brdf", ["lambertian", "ggx"])
def test_sample_rays_contract_on_the_cpu(bumpy_mesh, brdf, normal, contrib):
    cfg = pt.RenderConfig(num_samples=400, num_bins=300,
                          distance_resolution=5e-3, brdf=brdf, normal=normal)
    mesh, lighting, lnormal = _scene(bumpy_mesh, normal)
    Lc, F = lighting.shape[0], mesh.f.shape[0]
    spt, off, key = 3, 4095, pt.key(2**40 + 5)
    refine = cfg.bin_refine_resolution if contrib else None
    alpha = 0.2 if brdf == "ggx" else None
    faces = face_normals_areas(mesh.v, mesh.f)

    before = sk.sample_rays.launches
    got = sk.sample_rays(mesh, lighting, lnormal, key, cfg, spt, off, faces,
                         refine, alpha)
    assert sk.sample_rays.launches == before
    want = sk.sample_rays_plain(mesh, lighting, lnormal, key, cfg, spt, off,
                                faces, refine, alpha)
    unfaced = sk.sample_rays(mesh, lighting, lnormal, key, cfg, spt, off,
                             refine=refine, alpha=alpha)
    for c in (want, unfaced):
        for name, x in _fields(c).items():
            y = _fields(got)[name]
            assert (x is None) == (y is None) == (
                name in ("contrib", "bin_f") and not contrib), name
            assert x is None or torch.equal(x, y), name

    # the pieces: the draws, the face terms, the skip mask, the splat
    rays = got.rays
    assert rays.dirs.shape == (Lc, F, spt, 3)
    assert torch.equal(rays.bary, stratified_barycoords(key, Lc, F, spt, off,
                                                        device="cpu"))
    assert rays.face_n is faces[0] and rays.area is faces[1]
    assert not rays.valid[:, F - 2:].any() and not rays.valid[:, 3].any()
    assert rays.valid.any() and (~rays.valid).any()
    assert torch.equal(got.t_self, torch.where(got.t_self > 0,
                                               rays.h.reshape(-1), 0.0))
    assert bool((got.t_self[~rays.valid.reshape(-1)] == 0).all())
    assert torch.equal(got.fid, torch.arange(F, dtype=torch.int32)
                       .repeat_interleave(spt).repeat(Lc))
    assert torch.equal(got.o, lighting.repeat_interleave(F * spt, 0))
    if contrib:
        c, b = core._contrib_and_bins(rays, lnormal, cfg, spt, refine, alpha)
        assert torch.equal(got.contrib, c.reshape(-1))
        assert torch.equal(got.bin_f, b.reshape(-1))
        assert float(got.contrib.max()) > 0
        assert not got.contrib.reshape(Lc, -1)[-1].any()   # zero normal

    # what the visibility query and the splat are handed
    if contrib:
        rays_k, args, kw = core.splat_inputs(mesh, lighting, lnormal, key,
                                             cfg, spt, refine, off, alpha,
                                             faces)
        want_args = (got.o, rays.dirs.reshape(-1, 3), got.t_self, got.fid,
                     got.contrib, got.bin_f)
        assert args[9:] == (Lc, cfg.num_bins * refine)
    else:
        rays_k, args, kw = core.occlusion_inputs(mesh, lighting, lnormal, key,
                                                 cfg, spt, off, faces)
        want_args = (got.o, rays.dirs.reshape(-1, 3), got.t_self, got.fid)
    for x, y in zip(args, want_args):
        assert torch.equal(x, y)
    for x, y in zip(args[len(want_args):], (mesh.v, mesh.f, mesh.f_valid)):
        assert x is y
    for name, x in rays_k._asdict().items():
        assert torch.equal(x, getattr(rays, name)), name
    assert kw == dict(t_rel=cfg.occl_t_rel, t_min=cfg.occl_t_min)

    # inputs of the wrong dtype, shape or layout
    def call(m=mesh, lit=lighting, nrm=lnormal, k=key, fc=faces, a=alpha):
        return sk.sample_rays(m, lit, nrm, k, cfg, spt, off, fc, refine, a)

    bad = [dict(m=mesh._replace(f=mesh.f.int())),
           dict(m=mesh._replace(f_valid=mesh.f_valid.to(torch.uint8))),
           dict(m=mesh._replace(albedo=mesh.albedo[:-1])),
           dict(m=mesh._replace(vn=mesh.vn.t().contiguous().t())),
           dict(lit=lighting[:, :2]), dict(nrm=lnormal[:-1]),
           dict(lit=lighting.t().contiguous().t()),
           dict(lit=lighting.to(torch.int32)), dict(k=key.int()),
           dict(k=key[:1]), dict(fc=(faces[0], faces[1][:-1])),
           dict(fc=(faces[0].t().contiguous().t(), faces[1])),
           dict(a=torch.tensor([0.2, 0.3]))]
    for kw in bad:
        with pytest.raises(ValueError):
            call(**kw)
    assert sk.sample_rays.launches == before
