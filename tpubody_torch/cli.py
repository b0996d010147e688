"""Command-line interface of the port (port of ``tpubody.cli``): the
reference's entry points and the framework's training commands.

  python -m tpubody_torch.cli gen-smplh  <img> <keypoints.json> <out_dir>
  python -m tpubody_torch.cli reconstruct <test_dir> [--out <dir>]
  python -m tpubody_torch.cli animate     <avatar.pkl> <clip> <out.mp4>
  python -m tpubody_torch.cli demo        <out_dir>
  python -m tpubody_torch.cli train-hmr   --synthetic N --out <ckpt>

and ``gen-smplh-batch``, ``refine``, ``fit-video``, ``export-glb``,
``infer``, ``animate-batch``, ``train-pose2d`` and ``detect-pose``.  Every
command runs on the card unless ``--device cpu`` is given before the
command's name.  Checkpoints are single files (``utils/checkpoint.py``).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _cmd_gen_smplh(args) -> int:
    from tpubody_torch.pipelines import gen_smplh
    gen_smplh.gen_smplh(args.img, args.keypoints, args.out,
                        config_yaml=args.config, device=args.device)
    print(f"wrote {os.path.join(args.out, 'smplh.pkl')}  "
          f"(loss artifacts alongside)")
    return 0


def _cmd_gen_smplh_batch(args) -> int:
    """Batched fitting over fixture dirs (reference lib/gen_smplh.py:179-185
    loops serially; the port fits all frames as lanes of one batch)."""
    from tpubody_torch.pipelines import gen_smplh

    items = []
    for d in args.dirs:
        img = os.path.join(d, "front_rgb.png")
        keyp = os.path.join(d, "0_keypoints.json")
        if not (os.path.exists(img) and os.path.exists(keyp)):
            print(f"skipping {d}: needs front_rgb.png + 0_keypoints.json",
                  file=sys.stderr)
            continue
        out = os.path.join(args.out_root, os.path.basename(
            os.path.normpath(d))) if args.out_root else d
        items.append((img, keyp, out))
    if not items:
        print("no valid fixture dirs", file=sys.stderr)
        return 1
    mesh = None
    if args.shard and len(items) > 1:
        import torch

        from tpubody_torch.dist import mesh as mesh_lib
        if (torch.device(args.device).type == "cuda"
                and torch.cuda.device_count() > 1):
            mesh = mesh_lib.make_mesh()
    gen_smplh.gen_smplh_batch(items, config_yaml=args.config, mesh=mesh,
                              device=args.device)
    for _, _, out in items:
        print(f"wrote {os.path.join(out, 'smplh.pkl')}")
    return 0


def _cmd_refine(args) -> int:
    """HMR-warm-started SMPLify (SPIN-style regress-then-optimize)."""
    from tpubody_torch.pipelines import refine as refine_lib

    refine_lib.refine(
        [(args.img, args.keypoints, args.out)],
        config_yaml=args.config, hmr_ckpt=args.hmr_ckpt, device=args.device)
    print(f"wrote {os.path.join(args.out, 'smplh.pkl')} "
          "(artifacts alongside)")
    return 0


def _cmd_reconstruct(args) -> int:
    from tpubody_torch.models import params as params_lib
    from tpubody_torch.pipelines import reconstruct as rec
    from tpubody_torch.utils.profiling import StageTimer

    front, back, mask, fit = rec.load_test_dir(args.path)
    out_dir = args.out or args.path
    timer = StageTimer()
    rec.reconstruct(front, back, mask, fit,
                    params_lib.load_or_synthetic("smplh", n_joints=52),
                    params_lib.load_or_synthetic("smpl", n_joints=24),
                    out_dir=out_dir, replace_hands=args.replace_hands,
                    timer=timer, device=args.device)
    print(timer.report())
    print(f"wrote avatar + mesh artifacts to {out_dir}")
    return 0


def _load_clip(clip_path, asf=None, stride=1):
    """Load a motion clip by extension: AMASS .npz, CMU .amc (+ --asf), or a
    Mixamo result.pkl (which always plays at stride 1, model2video_miaxmo
    convention).  Returns (MotionClip, effective stride)."""
    from tpubody_torch.io import motion as motion_lib

    if clip_path.endswith(".npz"):
        return motion_lib.read_amass(clip_path), stride
    if clip_path.endswith(".amc"):
        if not asf:
            raise SystemExit("--asf <skeleton.asf> is required for .amc clips")
        from tpubody_torch.io import asf as asf_lib
        return asf_lib.read_amc(asf, clip_path), stride
    return motion_lib.read_mixamo(clip_path), 1


def _cmd_animate(args) -> int:
    from tpubody_torch.mesh import rigging
    from tpubody_torch.pipelines import animate

    avatar = rigging.load_avatar(args.avatar)
    if args.decimate:
        from tpubody_torch.mesh import decimate
        avatar = decimate.decimate_avatar(avatar, target_verts=args.decimate)
    clip, stride = _load_clip(args.clip, args.asf, args.stride)
    animate.animate_video(avatar, clip, args.out, size=args.size,
                          fps=args.fps, stride=stride,
                          cam_t=np.asarray([0.0, 0.0, args.cam_z]),
                          device=args.device)
    print(f"wrote {args.out}")
    return 0


def _cmd_fit_video(args) -> int:
    """Fit a keypoint sequence (sorted OpenPose JSONs) with temporal
    warm-start chaining + optional anchor smoothing; writes an .npz of
    per-frame fits and optionally a Mixamo-format result.pkl that
    `animate` consumes directly."""
    import dataclasses
    import glob as glob_lib

    from tpubody_torch.fit import keypoints as kp_lib
    from tpubody_torch.fit import smplify
    from tpubody_torch.io import motion as motion_lib
    from tpubody_torch.models import params as params_lib
    from tpubody_torch.pipelines import gen_smplh as gen_lib

    paths = sorted(glob_lib.glob(args.keypoints))
    if not paths:
        raise SystemExit(f"no keypoint files match {args.keypoints!r}")

    config = gen_lib.load_config(args.config)
    if args.temporal_weight is not None:
        config = dataclasses.replace(
            config, temporal_weight=args.temporal_weight)
    kps = np.stack([
        kp_lib.read_openpose_json(
            p, use_hands=gen_lib._hands(config),
            use_face=gen_lib._face(config),
            use_face_contour=config.use_face_contour).keypoints
        for p in paths])
    model = params_lib.load_or_synthetic(
        config.model_type,
        n_joints=gen_lib._FAMILY_JOINTS[config.model_type],
        n_verts=args.verts, device=args.device)
    center = np.asarray([args.cx, args.cy], np.float64)
    out = smplify.fit_sequence(model, kps.astype(np.float32), center,
                               config, chained=not args.independent,
                               device=args.device)
    np.savez(args.out, pose=out.pose, shape=out.shape,
             camera_translation=out.camera_translation,
             camera_center=out.camera_center, loss=out.loss,
             camera_fx=out.camera_fx)
    print(f"wrote {args.out} ({out.pose.shape[0]} frames, "
          f"mean loss {float(np.mean(out.loss)):.3f})")
    if args.clip_out:
        # SMPL-24 clip: a (T,72) SMPL fit reshapes directly; an SMPLH fit
        # takes global+body joints with zero hands (slicing [:72] would
        # leak left-finger rotations into slots 22/23).
        pose24 = (out.pose.reshape(-1, 24, 3) if out.pose.shape[1] == 72
                  else motion_lib.smplh156_to_smpl24(out.pose))
        motion_lib.save_mixamo(
            args.clip_out, pose24,
            cam=out.camera_translation, fps=args.fps)
        print(f"wrote {args.clip_out} (animate-compatible clip)")
    return 0


def _cmd_demo(args) -> int:
    from tpubody_torch.pipelines import demo as demo_lib

    arts = demo_lib.run_demo(
        args.out, size=args.size, verts=args.verts, seed=args.seed,
        fit=args.fit, animate_frames=args.frames, device=args.device)
    for name, path in sorted(arts.items()):
        print(f"  {name}: {path}")
    print(f"demo fixture + reconstruction in {args.out} "
          f"(reusable: `python -m tpubody_torch.cli reconstruct {args.out}`)")
    return 0


def _cmd_export_glb(args) -> int:
    from tpubody_torch.mesh import gltf as gltf_lib
    from tpubody_torch.mesh import rigging

    avatar = rigging.load_avatar(args.avatar)
    poses = trans = None
    fps = args.fps
    if args.clip:
        clip, stride = _load_clip(args.clip, args.asf, args.stride)
        poses = clip.poses[::stride]
        trans = clip.trans[::stride]
        if fps is None:
            fps = clip.fps / stride
    gltf_lib.export_avatar_glb(
        args.out, avatar, poses=poses, trans=trans, fps=fps or 30.0,
        max_influences=args.max_influences)
    print(f"wrote {args.out}")
    return 0


def _cmd_infer(args) -> int:
    """Images -> HMR -> SMPL meshes (OBJ/PLY per image): the flagship
    batched-inference path (pipelines/hmr_infer.py) from the CLI."""
    from tpubody_torch.mesh import meshio
    from tpubody_torch.models import params as params_lib
    from tpubody_torch.pipelines import hmr_infer

    smpl = params_lib.load(args.smpl) if args.smpl else None
    predictor = hmr_infer.HMRPredictor(smpl_model=smpl, device=args.device,
                                       arch=args.arch)
    if args.torch_ckpt:
        predictor.load_torch_checkpoint(args.torch_ckpt)
    result = predictor.from_files(args.images)
    os.makedirs(args.out, exist_ok=True)
    faces = np.asarray(predictor.smpl.faces)
    for i, p in enumerate(args.images):
        stem = os.path.splitext(os.path.basename(p))[0]
        verts = result.verts[i].float().cpu().numpy()
        out_path = os.path.join(args.out, stem + "." + args.format)
        if args.format == "obj":
            meshio.write_obj(out_path, verts, faces)
        else:
            meshio.write_ply(out_path, verts, faces)
        print(f"wrote {out_path}")
    np.savez(os.path.join(args.out, "params.npz"),
             **{k: getattr(result, k).float().cpu().numpy()
                for k in ("rotmats", "shape", "cam", "cam_t")})
    return 0


def _cmd_animate_batch(args) -> int:
    from tpubody_torch.pipelines import animate

    outs = animate.animate_mixamo_batch(
        args.avatar, args.mixamo_root, args.out_dir, prefix=args.prefix,
        size=args.size, cam_t=np.asarray([0.0, 0.0, args.cam_z]),
        device=args.device)
    for o in outs:
        print(f"wrote {o}")
    return 0


def _cmd_train_pose2d(args) -> int:
    """Renderer-supervised pose2d training (pipelines/pose_train.py);
    saves a checkpoint consumable by detect-pose --ckpt."""
    from tpubody_torch.pipelines import pose_train
    from tpubody_torch.utils import checkpoint as ckpt_lib

    init_params = None
    if args.resume:
        init_params = ckpt_lib.restore_pytree(args.resume)["variables"]
        print(f"resuming from {args.resume}")

    # Bundle the architecture with the weights so detect-pose can rebuild
    # the exact model (the synthetic trainer uses the body's joint count —
    # its n_joints default — not the 67-slot OpenPose layout).
    n_kp = 24

    def save(variables):
        ckpt_lib.save_pytree(args.out, {
            "variables": variables,
            "meta": {"n_keypoints": np.asarray(n_kp),
                     "features": np.asarray(args.features)},
        })

    chunk = max(1, args.chunk)
    save_every = max(chunk, args.save_every)

    def on_chunk(variables, done):
        # Periodic checkpointing: a crash costs at most save_every steps,
        # and --resume continues from the last save.  (done advances in
        # `chunk`-step increments, so the window scales with the chunk.)
        if done % save_every < chunk:
            save(variables)

    res = pose_train.train_pose2d_synthetic(
        steps=args.steps, batch=args.batch, size=args.size,
        features=args.features, lr=args.lr, domain_rand=args.domain_rand,
        init_params=init_params, on_chunk=on_chunk, chunk=args.chunk,
        device=args.device)
    if res.model.n_keypoints != n_kp:
        raise RuntimeError(f"trained {res.model.n_keypoints} keypoints, "
                           f"the checkpoint says {n_kp}")
    save(res.params)
    print(f"pixel err: {res.pixel_err_before:.4f} -> "
          f"{res.pixel_err_after:.4f} px over {args.steps} steps")
    print(f"wrote checkpoint to {args.out}")
    return 0


def _cmd_train_hmr(args) -> int:
    """Train HMR with the input pipeline in fp32; saves a checkpoint and
    ``<out>_metrics.jsonl``.

    Data: an .npz with images (N,S,S,3), keypoints2d (N,24,3) and optional
    gt_rotmats (N,24,3,3) / gt_shape (N,10) — or --synthetic N for a
    self-contained smoke run, or --render N for renderer-supervised
    humanoid examples."""
    import torch

    from tpubody_torch.device import resolve
    from tpubody_torch.io import dataset as ds
    from tpubody_torch.models import hmr as hmr_lib
    from tpubody_torch.models import hmr_train
    from tpubody_torch.models import params as params_lib
    from tpubody_torch.utils import checkpoint as ckpt_lib
    from tpubody_torch.utils.metrics import MetricsLogger

    dev = resolve(args.device)
    if args.render:
        data = ds.ArrayDataset([
            ds.preprocess_example(e, size=args.size)
            for e in ds.rendered_hmr_dataset(
                args.render, image_size=args.size + 16, device=dev)._examples])
    elif args.synthetic:
        data = ds.ArrayDataset([
            ds.preprocess_example(e, size=args.size)
            for e in ds.synthetic_hmr_dataset(
                args.synthetic, image_size=args.size + 16)._examples])
    else:
        z = np.load(args.data)
        n = len(z["images"])
        data = ds.ArrayDataset([
            ds.HMRExample(
                z["images"][i], z["keypoints2d"][i],
                z["gt_rotmats"][i] if "gt_rotmats" in z else None,
                z["gt_shape"][i] if "gt_shape" in z else None)
            for i in range(n)])

    model = hmr_lib.create_hmr(dtype=torch.float32, device=dev,
                               remat=args.remat)
    if args.render:
        # --render labels come from the capsule humanoid; the reprojection
        # loss / 3D eval must use the SAME body or their targets are
        # unreachable.
        from tpubody_torch.models import humanoid as humanoid_lib
        smpl = humanoid_lib.humanoid(
            n_joints=24, n_verts=max(args.verts, 1200), seed=0, device=dev)
    else:
        smpl = params_lib.synthetic(n_joints=24, n_verts=args.verts, seed=0,
                                    device=dev)
    state = hmr_train.create_train_state(model, lr=args.lr)
    step = hmr_train.make_train_step(smpl, img_size=float(args.size))

    loader = ds.DeviceLoader(
        data, batch_size=args.batch, num_epochs=None, seed=0,
        transforms=[lambda e, r: ds.random_flip(e, r)], device=dev)
    rng = torch.Generator(device=dev).manual_seed(0)
    it = iter(loader)
    try:
        with MetricsLogger(args.out + "_metrics.jsonl") as mlog:
            for i in range(args.steps):
                state, metrics = step(state, next(it), rng)
                loss = float(metrics["loss"])
                mlog.log("train", step=i, loss=loss)
                if i % max(1, args.steps // 10) == 0:
                    print(f"step {i}: loss {loss:.4f}")
            # Final 3D eval (MPJPE/PA-MPJPE/PVE, utils.pose_eval) on a
            # fresh batch when the data carries GT SMPL parameters.
            batch = next(it)
            if float(batch.has_smpl.sum()) > 0:
                ev = hmr_train.make_eval_step(smpl)(state, batch)
                ev = {k: float(v) for k, v in ev.items()}
                mlog.log("eval", step=args.steps, **ev)
                print("eval: " + "  ".join(f"{k} {v:.4f}"
                                           for k, v in ev.items()))
    finally:
        it.close()
    ckpt_lib.save_train_state(args.out, state)
    print(f"saved checkpoint to {args.out}")
    return 0


def _cmd_detect_pose(args) -> int:
    """Image -> 0_keypoints.json via the in-framework detector (the
    reference's lib/openpose.py openpose(img, save) contract)."""
    import json

    import torch

    from tpubody_torch.device import resolve
    from tpubody_torch.image import ops as img_ops
    from tpubody_torch.models import pose2d

    dev = resolve(args.device)
    img = img_ops.read_image(args.img)
    H = args.size
    side = max(img.shape[:2])
    inp = img_ops.scale_and_crop(
        img, (img.shape[1] / 2.0, img.shape[0] / 2.0), side / 200.0, H)
    if args.ckpt:
        from tpubody_torch.utils import checkpoint as ckpt_lib
        raw = ckpt_lib.restore_pytree(args.ckpt)
        if "meta" in raw:
            meta = raw["meta"]
            model = pose2d.Pose2D(
                n_keypoints=int(np.asarray(meta["n_keypoints"])),
                features=int(np.asarray(meta["features"])))
            model.load_state_dict(raw["variables"])
        else:  # bare state_dict: must match the default architecture
            model = pose2d.Pose2D()
            model.load_state_dict(raw)
        model.to(dev)
    else:
        model = pose2d.create_pose2d(device=dev)
        print("WARNING: detect-pose is EXPERIMENTAL and running with "
              "untrained weights — keypoints will not be usable for "
              "fitting; train with `train-pose2d` and pass --ckpt.",
              file=sys.stderr)
    with torch.no_grad():
        out = pose2d.detect(model.eval(), torch.as_tensor(
            inp[None] / 255.0, dtype=torch.float32, device=dev))
    kp = out.keypoints[0].double().cpu().numpy()
    # map from the square crop back to original pixels
    ratio = side / float(H)
    kp[:, 0] = kp[:, 0] * ratio + (img.shape[1] - side) / 2.0
    kp[:, 1] = kp[:, 1] * ratio + (img.shape[0] - side) / 2.0
    if kp.shape[0] < pose2d.N_KEYPOINTS:
        # models trained on fewer joints (synthetic bodies) fill the
        # leading body slots; the rest stay confidence-0
        pad = np.zeros((pose2d.N_KEYPOINTS - kp.shape[0], 3), np.float64)
        kp = np.concatenate([kp, pad], axis=0)
    person = pose2d.keypoints_to_openpose(kp)
    with open(args.out, "w") as f:
        json.dump({"version": 1.3, "people": [person]}, f)
    print(f"wrote {args.out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tpubody_torch.cli")
    parser.add_argument("--device", default="cuda",
                        help="torch device of every command (default: the "
                             "card; 'cpu' runs on the CPU)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("gen-smplh", help="fit SMPLH to keypoints")
    p.add_argument("img")
    p.add_argument("keypoints")
    p.add_argument("out")
    p.add_argument("--config", default=None, help="YAML config overrides")
    p.set_defaults(fn=_cmd_gen_smplh)

    p = sub.add_parser(
        "refine",
        help="HMR-initialized SMPLify fit (regress-then-optimize)")
    p.add_argument("img")
    p.add_argument("keypoints")
    p.add_argument("out")
    p.add_argument("--config", default=None, help="YAML config overrides")
    p.add_argument("--hmr-ckpt", default=None,
                   help="torch HMR checkpoint to convert and use")
    p.set_defaults(fn=_cmd_refine)

    p = sub.add_parser(
        "gen-smplh-batch",
        help="fit SMPLH to many fixture dirs in one batch")
    p.add_argument("dirs", nargs="+",
                   help="fixture dirs (front_rgb.png + 0_keypoints.json)")
    p.add_argument("--out-root", default=None,
                   help="write outputs under this root instead of in-place")
    p.add_argument("--config", default=None, help="YAML config overrides")
    p.add_argument("--shard", action="store_true",
                   help="shard the frame axis over all CUDA devices")
    p.set_defaults(fn=_cmd_gen_smplh_batch)

    p = sub.add_parser("reconstruct", help="full single-image reconstruction")
    p.add_argument("path", help="fixture dir with front/back/mask/smplh.pkl")
    p.add_argument("--out", default=None)
    p.add_argument("--replace-hands", action="store_true")
    p.set_defaults(fn=_cmd_reconstruct)

    p = sub.add_parser("animate", help="render avatar + motion clip to MP4")
    p.add_argument("avatar", help="rigged avatar pickle (or_recover.pkl)")
    p.add_argument("clip", help="AMASS .npz, Mixamo result.pkl, or CMU .amc")
    p.add_argument("--asf", default=None,
                   help="ASF skeleton file (required for .amc clips)")
    p.add_argument("out", help="output .mp4")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--fps", type=float, default=None)
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--cam-z", type=float, default=2.5)
    p.add_argument("--decimate", type=int, default=0,
                   help="cluster-decimate the avatar to ~N vertices first")
    p.set_defaults(fn=_cmd_animate)

    p = sub.add_parser(
        "fit-video",
        help="fit a keypoint sequence (video) with temporal chaining")
    p.add_argument("keypoints",
                   help="glob of OpenPose JSONs, e.g. 'frames/*_keypoints"
                        ".json' (sorted order = frame order)")
    p.add_argument("out", help="output .npz (pose/shape/camera per frame)")
    p.add_argument("--config", default=None, help="fitting conf.yaml")
    p.add_argument("--temporal-weight", type=float, default=None,
                   help="anchor each frame to the previous solution "
                        "(overrides config; 0 = off)")
    p.add_argument("--independent", action="store_true",
                   help="fit all frames independently in one batch "
                        "instead of chaining")
    p.add_argument("--cx", type=float, default=512.0)
    p.add_argument("--cy", type=float, default=512.0)
    p.add_argument("--clip-out", default=None,
                   help="also write a Mixamo-format result.pkl for "
                        "`animate`")
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--verts", type=int, default=6890,
                   help="synthetic-fallback vertex count (tests/benches)")
    p.set_defaults(fn=_cmd_fit_video)

    p = sub.add_parser(
        "demo",
        help="asset-free end-to-end demo: generate a reference-layout "
             "fixture from the capsule humanoid, reconstruct it (with "
             "hand grafting), animate a clip, export a skinned GLB")
    p.add_argument("out", help="output fixture/artifact directory")
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--verts", type=int, default=3000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--fit", action="store_true",
                   help="re-fit smplh.pkl from the generated keypoints "
                        "(staged SMPLify) instead of using ground truth")
    p.set_defaults(fn=_cmd_demo)

    p = sub.add_parser(
        "export-glb",
        help="export a rigged avatar (+ optional motion clip) as a "
             "skinned glTF binary")
    p.add_argument("avatar", help="rigged avatar pickle (or_recover.pkl)")
    p.add_argument("out", help="output .glb")
    p.add_argument("--clip", default=None,
                   help="AMASS .npz, Mixamo result.pkl, or CMU .amc to "
                        "embed as a glTF animation")
    p.add_argument("--asf", default=None,
                   help="ASF skeleton file (required for .amc clips)")
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--fps", type=float, default=None,
                   help="animation sample rate (default: the clip's)")
    p.add_argument("--max-influences", type=int, default=8,
                   help="skin influences kept per vertex (vec4 sets)")
    p.set_defaults(fn=_cmd_export_glb)

    p = sub.add_parser(
        "animate-batch",
        help="render every Mixamo clip under a directory tree to MP4s")
    p.add_argument("avatar", help="rigged avatar pickle (or_recover.pkl)")
    p.add_argument("mixamo_root",
                   help="directory of clip subdirs holding result.pkl")
    p.add_argument("out_dir", help="output directory for <prefix><clip>.mp4")
    p.add_argument("--prefix", default="or_")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--cam-z", type=float, default=2.5)
    p.set_defaults(fn=_cmd_animate_batch)

    p = sub.add_parser("infer",
                       help="images -> HMR -> SMPL meshes (batched)")
    p.add_argument("images", nargs="+", help="input image files")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--format", choices=("obj", "ply"), default="obj")
    p.add_argument("--arch", choices=("hmr_r50", "hmr2_vith"),
                   default="hmr_r50",
                   help="the regressor: HMR (ResNet-50 + IEF, 224^2 crops) "
                        "or HMR 2.0 (ViT-H/16 + cross-attention decoder, "
                        "256^2 crops)")
    p.add_argument("--torch-ckpt", default=None,
                   help="reference torch checkpoint to convert (SPIN's "
                        "HMR, or 4D-Humans' HMR 2.0 with --arch hmr2_vith)")
    p.add_argument("--smpl", default=None,
                   help="SMPL model file (pkl/npz); defaults to the "
                        "conventional asset spots / TPUBODY_SMPL_PATH, "
                        "then a synthetic stand-in with a warning")
    p.set_defaults(fn=_cmd_infer)

    p = sub.add_parser(
        "detect-pose",
        help="[EXPERIMENTAL] detect 2D keypoints -> OpenPose-format JSON "
             "(lib/openpose.py); without a trained --ckpt the detector is "
             "untrained and its keypoints are not usable for fitting")
    p.add_argument("img")
    p.add_argument("out", help="output keypoints .json")
    p.add_argument("--size", type=int, default=256,
                   help="square inference resolution")
    p.add_argument("--ckpt", default=None,
                   help="trained pose2d checkpoint (train-pose2d's file)")
    p.set_defaults(fn=_cmd_detect_pose)

    p = sub.add_parser(
        "train-pose2d",
        help="[EXPERIMENTAL] train the 2D keypoint detector on rendered "
             "synthetic bodies; saves a checkpoint for detect-pose")
    p.add_argument("--out", required=True, help="checkpoint output file")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--features", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--domain-rand", action="store_true",
                   help="randomize orientation/camera/background/photometry/"
                        "occlusion for transfer (pose_train.make_synthesizer)")
    p.add_argument("--resume", default=None,
                   help="checkpoint file to resume the weights from")
    p.add_argument("--save-every", type=int, default=500,
                   help="checkpoint every N steps (crash costs at most N)")
    p.add_argument("--chunk", type=int, default=100,
                   help="steps between checkpoint checks (tpubody's "
                        "compiled scan length; the last chunk runs whole)")
    p.set_defaults(fn=_cmd_train_pose2d)

    p = sub.add_parser("train-hmr",
                       help="train HMR (keypoint + SMPL supervision)")
    p.add_argument("--data", default=None, help="dataset .npz")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic (noise-image) examples instead "
                        "of --data")
    p.add_argument("--render", type=int, default=0,
                   help="use N renderer-supervised humanoid examples "
                        "(true rotmat/shape/keypoint labels)")
    p.add_argument("--out", required=True, help="checkpoint output file")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--verts", type=int, default=6890)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--remat", action="store_true",
                   help="rematerialize backbone blocks on backward "
                        "(less activation memory, larger batches)")
    p.set_defaults(fn=_cmd_train_hmr)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
