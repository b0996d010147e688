"""tpubody_torch.models.pose2d against tpubody.models.pose2d on the CPU in
float32.  The forward runs on converted weights at 32^2 and 48^2
(features 8, 4 residual blocks, 5 keypoints), which pins the SAME pads of
the stride-2 convolutions, GroupNorm's epsilon 1e-6 and the transposed
convolution's kernel flip.  Bars: logits relative 1e-5 of the largest
(float32 convolutions in another summation order); decoded keypoints
1e-4 px; loss relative 1e-5; one Adam step compared where |g| > 1e-3 *
max |g| of the tensor (the first Adam update is about lr * sign(g)),
within 1e-3 * lr; a tensor whose gradient is zero up to rounding (max
|g| under 1e-4 of the largest of any tensor) is skipped: the heads' bias,
to which the spatial softmax is invariant."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpubody.fit import keypoints as jkp
from tpubody.models import pose2d as jpose
from tpubody.utils.flaxtools import shape_init
from tpubody_torch.models import pose2d as tpose

torch.set_num_threads(1)

K = 5
FEAT = 8
LR = 1e-3


def _variables(size, seed=0):
    model = jpose.Pose2D(n_keypoints=K, features=FEAT, n_blocks=4)
    v = shape_init(model, jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1]).strip(".[]'\"")
        x = np.array(x, np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x
    return model, jax.tree_util.tree_map_with_path(leaf, v)


def _port(v):
    net = tpose.Pose2D(n_keypoints=K, features=FEAT, n_blocks=4)
    net.load_state_dict(tpose.from_flax_variables(v))
    return net


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("size", [32, 48])
def test_forward_matches_flax(size):
    model, v = _variables(size)
    x = np.random.default_rng(1).normal(size=(2, size, size, 3)) \
        .astype(np.float32)
    want = jpose.detect(model, v, jnp.asarray(x))
    with torch.no_grad():
        got = tpose.detect(_port(v), torch.as_tensor(x))
    assert got.heatmaps.shape == (2, size // 4, size // 4, K)
    assert _rel(got.heatmaps.numpy(), np.asarray(want.heatmaps)) < 1e-5
    np.testing.assert_allclose(got.keypoints[..., :2].numpy(),
                               np.asarray(want.keypoints[..., :2]),
                               atol=1e-4)
    np.testing.assert_allclose(got.keypoints[..., 2].numpy(),
                               np.asarray(want.keypoints[..., 2]),
                               atol=1e-5)


def _kps(B=2, size=32, seed=2):
    rng = np.random.default_rng(seed)
    kp = np.concatenate([rng.uniform(2, size - 2, (B, K, 2)),
                         np.ones((B, K, 1))], -1).astype(np.float32)
    kp[0, 1, 2] = 0.0                      # one masked keypoint
    return kp


def test_soft_argmax_and_targets():
    kp = _kps()
    want_t = jpose.make_target_heatmaps(jnp.asarray(kp), (8, 8))
    got_t = tpose.make_target_heatmaps(torch.as_tensor(kp), (8, 8))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=1e-6)
    logits = np.random.default_rng(3).normal(size=(2, 8, 8, K)) \
        .astype(np.float32) * 3
    np.testing.assert_allclose(
        tpose.soft_argmax(torch.as_tensor(logits)).numpy(),
        np.asarray(jpose.soft_argmax(jnp.asarray(logits))), atol=1e-4)


def test_heatmap_loss():
    kp = _kps()
    logits = np.random.default_rng(4).normal(size=(2, 8, 8, K)) \
        .astype(np.float32)
    want = float(jpose.heatmap_loss(jnp.asarray(logits), jnp.asarray(kp)))
    got = float(tpose.heatmap_loss(torch.as_tensor(logits),
                                   torch.as_tensor(kp)))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_one_train_step_matches():
    model, v = _variables(32)
    x = np.random.default_rng(5).normal(size=(2, 32, 32, 3)) \
        .astype(np.float32)
    kp = _kps()
    tx = optax.adam(LR)

    def lossf(p):
        return jpose.heatmap_loss(model.apply(p, jnp.asarray(x)),
                                  jnp.asarray(kp))
    grads = jax.grad(lossf)(v)
    step = jpose.make_train_step(model, tx)
    new_v, _, loss = step(v, tx.init(v), jnp.asarray(x), jnp.asarray(kp))

    net = _port(v)
    before = {k: t.clone() for k, t in net.state_dict().items()}
    opt = torch.optim.Adam(net.parameters(), lr=LR)
    got_loss = tpose.make_train_step(net, opt)(torch.as_tensor(x),
                                               torch.as_tensor(kp))
    assert abs(float(got_loss) - float(loss)) <= 1e-5 * float(loss)
    want_sd = tpose.from_flax_variables(new_v)
    g_sd = tpose.from_flax_variables(grads)
    g_max = max(float(g.abs().max()) for g in g_sd.values())
    skipped = []
    for k, w in want_sd.items():
        g = g_sd[k].numpy()
        if np.abs(g).max() < 1e-4 * g_max:
            skipped.append(k)
            continue
        mask = np.abs(g) > 1e-3 * np.abs(g).max()
        d_got = (net.state_dict()[k] - before[k]).numpy()
        d_want = (w - before[k]).numpy()
        np.testing.assert_allclose(d_got[mask], d_want[mask], rtol=0,
                                   atol=1e-3 * LR, err_msg=k)
    assert skipped == ["head.bias"]


def test_keypoints_to_openpose_reads_back(tmp_path):
    import json
    kp = np.random.default_rng(6).uniform(0, 100, (67, 3))
    got = tpose.keypoints_to_openpose(kp)
    assert got == jpose.keypoints_to_openpose(kp)
    path = tmp_path / "k.json"
    path.write_text(json.dumps({"version": 1.3, "people": [got]}))
    back = jkp.read_openpose_json(str(path), use_hands=True,
                                  use_face=False).keypoints
    assert back.shape[0] == 67
    np.testing.assert_allclose(back[:25], kp[:25], atol=1e-5)


def test_create_pose2d_is_seeded():
    a = tpose.create_pose2d(n_keypoints=K, features=FEAT, device="cpu")
    b = tpose.create_pose2d(n_keypoints=K, features=FEAT, device="cpu")
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k
    assert a(torch.zeros(1, 32, 32, 3)).shape == (1, 8, 8, K)
