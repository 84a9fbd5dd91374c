"""PyTorch port parity: the whole ThinkTwice student's training step input
(forward with the teacher pass, total_loss, gradients) of
thinktwice_tpu_torch against thinktwice_tpu's on the CPU.

The model is the frozen dry-run shape (`__graft_entry__._DRYRUN_FROZEN`:
ResNet-10, 2 cameras of 32 x 64, one refine layer, 2 future steps) with two
sweeps, a sweep-to-key transform, IDA matrices and the teacher pass, its
parameters a flax init through the port's converter, its batch made from a
seed.

- In bfloat16, as both models compute: every loss term agrees to 2e-2 of
  its value. The gradients of the two bfloat16 models are each as noisy as
  the other: at these shapes either's global cosine with the exact
  gradient is ~0.93-0.95 and single small leaves fall to ~0.7 (two
  bfloat16 runs that round in other orders), so a per-leaf cosine of 0.99
  between them cannot hold. What is checked: the port's bfloat16 gradient
  is as close to the exact gradient as JAX's bfloat16 one, within 0.02 of
  its global cosine.
- In full precision (the port's bfloat16 compute switched to float32, the
  JAX model's bfloat16 and float32 to float64, its exact reference): every
  loss term agrees to 1e-4 of its value, every parameter's gradient whose
  norm exceeds 1e-3 of the global norm has a cosine similarity of at least
  0.9999 with the reference's, and the whole gradient differs from it by at
  most 1e-2 of its norm. This holds the backward pass itself: the
  rematerialized blocks, the detached cascade, the losses. An elementwise
  bound does not hold in float32: the depth softmax and some group norms
  are ill-conditioned, and the port's own gradient moves by up to 3% of a
  leaf's largest element between two float32 conv implementations
  (oneDNN's or ATen's), at a cosine of 0.99995.
- The history sweep's images get no gradient in either package.
"""

import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_train_model import CAMS, ida_mats, random_params
from thinktwice_tpu.config import CameraConfig as JaxCameraConfig
from thinktwice_tpu.config import ModelConfig as JaxModelConfig
from thinktwice_tpu.models import rig as jrig
from thinktwice_tpu.models.encoder_decoder import ThinkTwiceModel as JaxThinkTwiceModel
from thinktwice_tpu.models.encoder_decoder import total_loss as jax_total_loss
from thinktwice_tpu_torch.config import ModelConfig
from thinktwice_tpu_torch.models import encoder_decoder as ted
from thinktwice_tpu_torch.models import lidarnet as tlidar
from thinktwice_tpu_torch.models import lss as tlss
from thinktwice_tpu_torch.weights import student_state_dict_from_flax

torch.set_num_threads(1)

FROZEN = dict(img_height=32, img_width=64, refine_num=1, pred_len=2, bev_channels=64,
              n_depth_bins=16, lidar_pillar_grid=84, n_z_anchors=5, n_attn_heads=4)
LOSS_TOL_BF16 = 2e-2
COS_MARGIN_BF16 = 0.02
LOSS_TOL_F32 = 1e-4
MIN_COS_F32 = 0.9999
GLOBAL_TOL_F32 = 1e-2


def model_inputs(B=2, T=2, N=2, P=256, seed=0):
    """(model args, sweep2key, ida, loss batch) made from a seed."""
    rng = np.random.default_rng(seed)
    jc = JaxCameraConfig(**CAMS)
    pts = np.concatenate([rng.uniform(-10, 32, (B, P, 2)), rng.uniform(-2, 3, (B, P, 1)),
                          rng.uniform(0, 1, (B, P, 2))], -1).astype(np.float32)
    s2k = np.tile(np.eye(4, dtype=np.float32), (B, T, 1, 1))
    s2k[:, 0, 0, 3] = -1.5
    s2k[:, 0, :2, :2] = [[0.995, -0.0998], [0.0998, 0.995]]
    args = [rng.standard_normal((B, T, N, 32, 64, 3)).astype(np.float32), pts,
            rng.uniform(size=(B, P)) > 0.2, rng.uniform(0, 5, B).astype(np.float32),
            rng.uniform(-5, 20, (B, 2)).astype(np.float32),
            np.eye(6, dtype=np.float32)[[3, 1]][:B],
            jrig.cam_to_ego(jc), jrig.intrinsics(jc), jrig.ego_to_img(jc)]
    pl = FROZEN["pred_len"]

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    def pos(*s):
        return np.abs(f(*s)) + 0.5

    depth = rng.uniform(2.0, 45.0, (B * N, 32, 64)).astype(np.float32)
    depth[:, :, :16] = 0.0
    batch = {
        "teacher_wp": f(B, pl, 2) * 3, "teacher_ctrl_sp": pos(B, pl, 4),
        "gt_waypoints": f(B, pl, 2) * 3, "action_alpha": pos(B, 2), "action_beta": pos(B, 2),
        "future_action_alpha": pos(B, pl - 1, 2), "future_action_beta": pos(B, pl - 1, 2),
        # driving speeds: |pred - gt| then is not a near-cancellation of
        # the untrained head's output
        "gt_speed": rng.uniform(2.0, 8.0, B).astype(np.float32), "gt_value": f(B),
        "roach_features": f(B, 256),
        "roach_cnn": (f(B, 21, 21, 32), f(B, 10, 10, 64), f(B, 4, 4, 128), f(B, 2, 2, 256)),
        "future_roach_cnn21": f(B, pl, 21, 21, 32), "gt_depth": depth,
        "gt_seg": rng.integers(0, 12, (B * N, 8, 16)).astype(np.int32),
        "distil_weight": np.array([1.0, 0.0], np.float32),
    }
    return args, s2k, ida_mats(B, N, 32, 64, seed=5), batch


def _torch_batch(batch):
    def one(x):
        t = torch.as_tensor(np.asarray(x))
        return t.long() if t.dtype == torch.int32 else t

    return {k: tuple(one(x) for x in v) if isinstance(v, tuple) else one(v)
            for k, v in batch.items()}


def _jax_run(jmodel, jcfg, params, args, s2k, ida, batch):
    """-> (loss terms, parameter gradients, image gradients)."""
    jargs = [jnp.asarray(a) for a in args]
    jb = jax.tree.map(jnp.asarray, batch)

    def loss(p, imgs):
        outs = jmodel.apply(p, imgs, *jargs[1:], jb["teacher_wp"], jb["teacher_ctrl_sp"],
                            sweep2key=jnp.asarray(s2k), ida=jnp.asarray(ida))
        return jax_total_loss(jcfg, outs, jb)

    (_, terms), (g, gimg) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jargs[0])
    return ({k: float(v) for k, v in terms.items()}, jax.tree.map(np.asarray, g),
            np.asarray(gimg))


def _port_run(params, args, s2k, ida, batch):
    model = ted.ThinkTwiceModel(ModelConfig(**FROZEN), backbone_depth=10, n_sweeps=2,
                                n_cams=2)
    model.load_state_dict(student_state_dict_from_flax(params, model), strict=True)
    tb = _torch_batch(batch)
    imgs = torch.as_tensor(args[0]).requires_grad_(True)
    outs = model(imgs, *[torch.as_tensor(a) for a in args[1:]], tb["teacher_wp"],
                 tb["teacher_ctrl_sp"], sweep2key=torch.as_tensor(s2k),
                 ida=torch.as_tensor(ida))
    loss, terms = ted.total_loss(ModelConfig(**FROZEN), outs, tb)
    loss.backward()
    return model, {k: float(v.detach()) for k, v in terms.items()}, imgs.grad


def _full_precision():
    """The port's bfloat16 compute switched to float32, the JAX package's
    bfloat16 and float32 to float64."""
    return [jax.enable_x64(True), mock.patch.object(ted, "BF16", torch.float32),
            mock.patch.object(tlss, "BF16", torch.float32),
            mock.patch.object(tlidar, "BF16", torch.float32),
            mock.patch.object(jnp, "bfloat16", jnp.float64),
            mock.patch.object(jnp, "float32", jnp.float64)]


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _flat(grads: dict) -> np.ndarray:
    return np.concatenate([np.asarray(grads[k]).ravel() for k in sorted(grads)])


def test_student_training_step_matches_flax():
    args, s2k, ida, batch = model_inputs()
    jcfg = JaxModelConfig(**FROZEN)
    jmodel = JaxThinkTwiceModel(jcfg, backbone_depth=10, n_sweeps=2)
    jargs = [jnp.asarray(a) for a in args]
    params = random_params(jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), *jargs, jnp.asarray(batch["teacher_wp"]),
        jnp.asarray(batch["teacher_ctrl_sp"]), sweep2key=jnp.asarray(s2k),
        ida=jnp.asarray(ida))))

    # bfloat16, as both models compute
    ref_terms, ref_g16, ref_gimg = _jax_run(jmodel, jcfg, params, args, s2k, ida, batch)
    model, terms, gimg = _port_run(params, args, s2k, ida, batch)
    assert set(terms) == set(ref_terms)
    for k, want in ref_terms.items():
        assert np.isfinite(terms[k]), k
        assert abs(terms[k] - want) <= LOSS_TOL_BF16 * max(abs(want), 1e-6), (k, terms[k], want)
    port_g16 = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
                for k, p in model.named_parameters()}
    ref_g16 = student_state_dict_from_flax(ref_g16, model)
    # the history sweep (index 0) carries no gradient; the key sweep does
    assert not gimg[:, 0].any() and not ref_gimg[:, 0].any()
    assert gimg[:, 1].abs().sum() > 0 and np.abs(ref_gimg[:, 1]).sum() > 0

    # full precision: the backward itself
    with contextlib.ExitStack() as stack:
        for p in _full_precision():
            stack.enter_context(p)
        p64 = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
        b64 = {k: (tuple(np.asarray(x, np.float64) for x in v) if isinstance(v, tuple)
                   else np.asarray(v, np.float64) if np.asarray(v).dtype == np.float32 else v)
               for k, v in batch.items()}
        a64 = [np.asarray(a, np.float64) if np.asarray(a).dtype == np.float32 else a
               for a in args]
        ref32_terms, ref_g32, _ = _jax_run(jmodel, jcfg, p64, a64, np.float64(s2k),
                                           np.float64(ida), b64)
        model32, terms32, _ = _port_run(params, args, s2k, ida, batch)
    for k, want in ref32_terms.items():
        assert abs(terms32[k] - want) <= LOSS_TOL_F32 * max(abs(want), 1e-6), (k, terms32[k],
                                                                                 want)
    ref_g32 = {k: v.numpy() for k, v in student_state_dict_from_flax(ref_g32, model32).items()}
    got32 = {k: (np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy())
             for k, p in model32.named_parameters()}
    total = float(np.linalg.norm(_flat(ref_g32)))
    checked = 0
    for name, want in ref_g32.items():
        if np.linalg.norm(want) > 1e-3 * total:
            assert _cos(got32[name], want) >= MIN_COS_F32, (name, _cos(got32[name], want))
            checked += 1
    assert checked > 200
    assert np.linalg.norm(_flat(got32) - _flat(ref_g32)) <= GLOBAL_TOL_F32 * total

    # the port's bfloat16 gradient is as good as the reference's
    exact = _flat(ref_g32)
    cos_port, cos_ref = _cos(_flat(port_g16), exact), _cos(_flat(ref_g16), exact)
    assert cos_port >= cos_ref - COS_MARGIN_BF16, (cos_port, cos_ref)
