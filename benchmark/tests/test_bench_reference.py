"""The plain reference at a tiny size: against itself, against independent
float64 arithmetic, and beside the port (which the reference never
imports)."""
import ast
import glob
import os

import numpy as np
import pytest
import torch

from benchmark import compare, generate, harness
from benchmark.models import hmr_r50, hmr_smpl_step, smpl_body
from benchmark.reference import hmr_int8, hmr_smpl

SEED = 2 ** 35 + 9
STAGES = (1, 1, 1, 1)
REF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                       "reference")


@pytest.fixture(scope="module")
def made():
    weights = hmr_r50.make(SEED, "cpu", STAGES)
    body = smpl_body.make(SEED, "cpu", n_verts=300)
    mix = harness.mix_of("offline_batches")
    images = generate.images(mix["images"], 6, 64, SEED, "t", "cpu")
    return weights, body, hmr_smpl_step.mean_params(SEED, "cpu"), images


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "contextlib", "typing", "torch", "benchmark"}
    for path in glob.glob(os.path.join(REF_DIR, "*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path, name)
                if name.startswith("benchmark"):
                    assert name.startswith("benchmark.reference"), name


def test_rot6d_gives_rotations():
    x = torch.randn(50, 6, generator=torch.Generator().manual_seed(0))
    R = hmr_smpl.rot6d_to_rotmat(x)
    eye = torch.eye(3).expand(50, 3, 3)
    assert torch.allclose(R.transpose(1, 2) @ R, eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(R), torch.ones(50), atol=1e-5)
    ident = hmr_smpl.rot6d_to_rotmat(torch.tensor([1., 0, 0, 1, 0, 0]))
    assert torch.allclose(ident, torch.eye(3))


def _lbs_float64(body, parents, R, betas):
    """SMPL by 4x4 homogeneous transforms, one frame at a time."""
    b = {k: v.double().numpy() for k, v in body.items()}
    out = []
    for Rf, beta in zip(R.double().numpy(), betas.double().numpy()):
        v = b["v_template"] + b["shapedirs"] @ beta
        J = b["j_regressor"] @ v
        feat = (Rf[1:] - np.eye(3)).reshape(-1)
        v = v + b["posedirs"] @ feat
        G = []
        for i, p in enumerate(parents):
            local = np.eye(4)
            local[:3, :3] = Rf[i]
            local[:3, 3] = J[i] - (J[p] if p >= 0 else 0)
            G.append(local if p < 0 else G[p] @ local)
        A = []
        for i, g in enumerate(G):
            rest = np.eye(4)
            rest[:3, 3] = -J[i]
            A.append(g @ rest)
        T = np.einsum("vj,jab->vab", b["weights"], np.stack(A))
        vh = np.concatenate([v, np.ones((len(v), 1))], axis=1)
        out.append(np.einsum("vab,vb->va", T, vh)[:, :3])
    return np.stack(out)


def test_skinning_against_float64(made):
    _, body, _, _ = made
    gen = torch.Generator().manual_seed(1)
    R = hmr_smpl.rot6d_to_rotmat(torch.randn(3, 24, 6, generator=gen))
    betas = torch.randn(3, 10, generator=gen)
    got = hmr_smpl.smpl_vertices(body, smpl_body.SMPL_PARENTS, R, betas)
    want = _lbs_float64(body, smpl_body.SMPL_PARENTS, R, betas)
    assert np.abs(got.numpy() - want).max() < 1e-5


def test_blocks_do_not_change_the_answer(made):
    weights, body, mean, images = made
    args = (weights, body, smpl_body.SMPL_PARENTS, mean, images, STAGES, 3)
    v1, c1 = hmr_smpl.forward(*args, block=1)
    v4, c4 = hmr_smpl.forward(*args, block=4)
    assert torch.allclose(v1, v4, atol=1e-5) and torch.allclose(c1, c4,
                                                                atol=1e-5)


def test_port_in_float32_agrees_with_the_reference(made):
    from tpubody_torch.pipelines.serving import HMRSMPLStep

    weights, body, mean, images = made
    cfg = {"ief_iterations": 3, "stage_sizes": STAGES}
    model = hmr_smpl_step.load_hmr(cfg, weights, mean, torch.float32,
                                   torch.device("cpu"))
    step = HMRSMPLStep(model, hmr_smpl_step.body_params(body), "cpu", 64)
    got = tuple(t.numpy() for t in step(images.numpy()))
    want = tuple(t.numpy() for t in hmr_smpl.forward(
        weights, body, smpl_body.SMPL_PARENTS, mean, images, STAGES, 3))
    scales = [compare.spread(w) for w in want]
    assert compare.frame_errors(got, want, scales).max() < 1e-3


def test_int8_reference_matches_the_port_and_the_folded_network(made):
    from tpubody_torch.models import hmr_quant

    weights, body, mean, images = made
    calib = images[:4]
    qparams = hmr_int8.prepare(weights, calib, STAGES, 8)
    cfg = {"ief_iterations": 3, "stage_sizes": STAGES}
    model = hmr_smpl_step.load_hmr(cfg, weights, mean, torch.float32,
                                   torch.device("cpu"))
    port = hmr_quant.quantize_hmr(model, calib)
    want = hmr_int8.backbone(qparams, images, STAGES, 8)
    got = hmr_quant._backbone_int8(port, images)
    assert torch.equal(got, want)
    folded = hmr_int8.fold(weights, STAGES)

    def conv(name, x):
        w, b, stride, padding = folded[name]
        return torch.nn.functional.conv2d(x, w, b, stride=stride,
                                          padding=padding)

    plain = hmr_smpl.resnet50(weights, images, STAGES)
    via_fold = hmr_int8._network(folded, images.permute(0, 3, 1, 2), STAGES,
                                 conv)
    assert torch.allclose(plain, via_fold, rtol=1e-4, atol=1e-4)


def test_controls_are_far_from_the_reference(made):
    weights, body, mean, images = made
    args = (body, smpl_body.SMPL_PARENTS, mean, images, STAGES, 3)
    ref = hmr_smpl.forward(weights, *args)
    fp8 = hmr_smpl.forward(weights, *args, operand=hmr_smpl.fp8)
    scales = [compare.spread(r.numpy()) for r in ref]
    err = compare.frame_errors(tuple(t.numpy() for t in fp8),
                               tuple(t.numpy() for t in ref), scales)
    assert err.max() > 0.5
    q8 = hmr_int8.prepare(weights, images[:4], STAGES, 8)
    q4 = hmr_int8.prepare(weights, images[:4], STAGES, 4)
    r8 = hmr_int8.forward(q8, weights, *args, bits=8)
    r4 = hmr_int8.forward(q4, weights, *args, bits=4)
    scales = [compare.spread(r.numpy()) for r in r8]
    err = compare.frame_errors(tuple(t.numpy() for t in r4),
                               tuple(t.numpy() for t in r8), scales)
    assert err.max() > 0.5
