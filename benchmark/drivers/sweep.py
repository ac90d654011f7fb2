"""The general generator of novel-view sweeps: one client in a closed loop,
as `generate-novel-depths` runs.

Set-up builds the program's SceneRF in eval mode on weights drawn from the
seed, makes the traffic's frames (host numpy) and the configuration's pose
sweep, builds the camera's sphere maps once, and warms up every shape with
one encode and one pose. The window then takes the frames in turn: each is
uploaded and encoded (`SceneRF.encode`, ended by a synchronize), then every
pose of the sweep is rendered (`SceneRF.render_image` at the traffic's
stride and ray chunk, its noise from a generator seeded per frame and pose)
and its depth and color copied to the host. A pose is timed from when it is
asked for until both are on the host. Once the window has closed, the
reference renders a sample of the poses finished in it, drawn from the
seed, from the same weights, frame and generator seed.

Traffic keys: `frames`, `stride`, `ray_chunk`, `profile_poses` (poses of
the next frame traced after the window in a traced run, with its encode),
`check_poses` (the sample the reference renders).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.drivers.train import (in_f32, precision, program_config, program_model,
                                     reference_config, reference_model)
from benchmark.harness import compare, inputs
from benchmark.harness.trace import Brackets, profiled

KIND = "sweep"


class Driver:
    kind = KIND

    def __init__(self, cell, seed: int, device, fault: Optional[str] = None):
        """`fault` (tests and the readings of the limits only): "altered"
        scales every rendered depth by 1.2 where it is produced;
        "witness_f32" is no fault but the program computing in float32."""
        self.cell, self.conf, self.traffic = cell, cell.conf, cell.traffic
        self.seed, self.device, self.fault = seed, torch.device(device), fault
        self.program_conf = in_f32(self.conf) if fault == "witness_f32" else self.conf
        self.cfg = program_config(self.program_conf)
        self.exact = self.cfg.compute_dtype == "float32"  # TF32 off for the program
        self.f32_side = self.conf["dtype"] != "float32"  # a float32 reference beside
        self.stride, self.chunk = int(self.traffic["stride"]), int(self.traffic["ray_chunk"])
        W, H = self.cfg.img_size
        self.rays_per_pose = -(-H // self.stride) * -(-W // self.stride)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from scenerf_tpu_torch.model import to_device

        if self.exact:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        dev, sw = self.device, self.conf["sweep"]
        self.to_device = to_device
        self.frames = [inputs.make_frame(self.conf, self.cfg, self.seed, i)
                       for i in range(int(self.traffic["frames"]))]
        self.poses_np = inputs.sweep_poses(sw["step"], sw["angles"], sw["max_distance"])
        self.poses = torch.from_numpy(self.poses_np).to(dev)
        self.cam_K_np = inputs.camera(self.conf)
        self.cam_K = torch.from_numpy(self.cam_K_np).to(dev)
        self.model = program_model(self.program_conf, self.seed, dev).eval()
        self.maps = {s: torch.as_tensor(m, device=dev)
                     for s, m in self.model.compute_sphere_maps(self.cam_K_np).items()}
        self.next_frame = 0
        # warm-up: one encode and one pose at the window's shapes
        pyramid = self.encode(self.frames[0])
        self.render(pyramid, 0, 0)
        self._sync()

    def encode(self, frame: np.ndarray):
        img = self.to_device(torch.from_numpy(frame), self.device)
        levels = self.model.encode(img, self.cam_K, sphere_maps=self.maps)
        return self.model.pyramid_for_item(levels, 0)

    def render(self, pyramid, frame: int, pose: int) -> Dict[str, torch.Tensor]:
        g = torch.Generator(device=self.device).manual_seed(
            inputs.pose_seed(self.seed, frame, pose))
        out = self.model.render_image(pyramid, self.cam_K, self.poses[pose], g,
                                      stride=self.stride, ray_chunk=self.chunk)
        if self.fault == "altered":
            out = {**out, "depth": out["depth"] * 1.2}
        return out

    # ------------------------------------------------------------ window
    def window(self, seconds: float, brackets: Brackets) -> dict:
        self.done: List[tuple] = []  # (frame, pose, depth, color) on the host
        pose_ms: List[float] = []
        failed, encodes = 0, 0
        self._sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            f = self.next_frame
            self.next_frame += 1
            with brackets("encode"):
                pyramid = self.encode(self.frames[f % len(self.frames)])
                self._sync()
            encodes += 1
            for p in range(len(self.poses_np)):
                if time.perf_counter() - t0 >= seconds:
                    break
                ta = time.perf_counter()
                try:
                    with brackets("render_image"):
                        out = self.render(pyramid, f, p)
                    with brackets("to_host"):
                        depth, color = out["depth"].cpu(), out["color"].cpu()
                    ok = bool(torch.isfinite(depth).all() and torch.isfinite(color).all())
                except Exception as e:  # a pose that raises has failed
                    print(f"frame {f} pose {p} raised: {e!r}", flush=True)
                    ok = False
                pose_ms.append((time.perf_counter() - ta) * 1e3)
                if ok:
                    self.done.append((f, p, depth, color))
                else:
                    failed += 1
            del pyramid
        self._sync()
        wall = time.perf_counter() - t0
        poses = len(pose_ms)
        self.window_poses, self.window_encodes, self.window_s = poses, encodes, wall
        return {"attempted": poses, "failed": failed, "seconds": wall, "units": poses,
                "encodes": encodes,
                "metrics": {"render_rays_per_s": poses * self.rays_per_pose / wall,
                            "pose_ms_p90": float(np.percentile(pose_ms, 90)) if pose_ms
                            else float("nan")}}

    def profile(self, out_dir, holder: dict) -> None:
        brackets = Brackets()
        f = self.next_frame
        with profiled(out_dir / "trace.json", brackets, holder):
            with brackets("encode"):
                pyramid = self.encode(self.frames[f % len(self.frames)])
            for p in range(int(self.traffic["profile_poses"])):
                with brackets("render_image"):
                    out = self.render(pyramid, f, p)
                with brackets("to_host"):
                    out["depth"].cpu(), out["color"].cpu()
        holder["units"] = int(self.traffic["profile_poses"])
        holder["encodes"] = 1

    def release(self) -> None:
        del self.model, self.maps
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ check
    def sample(self) -> List[tuple]:
        """The poses the reference renders: `check_poses` of those finished
        in the window, drawn from the seed."""
        rng = np.random.default_rng([int(self.seed) % (1 << 64), 6])
        n = min(int(self.traffic["check_poses"]), len(self.done))
        return [self.done[i] for i in sorted(rng.choice(len(self.done), n, replace=False))]

    def reference(self, picks: List[tuple], lower: Optional[str] = None,
                  conf: Optional[dict] = None) -> List[dict]:
        """The reference's depth and color of `picks` ("ref_depth",
        "ref_color", beside the program's "depth" and "color"), in `conf`'s
        precision (the cell's by default) with TF32 off, or in the control's
        precision (`lower`); the encoder in eval mode."""
        from benchmark.reference import sampling as RS

        dev, conf = self.device, conf or self.conf
        model = reference_model(conf, dev)
        model.load_state_dict(inputs.draw_weights(
            {k: v.shape for k, v in model.state_dict().items()}, self.seed, dev))
        model.eval()
        cam_K = torch.from_numpy(self.cam_K_np).to(dev)
        maps = {s: torch.as_tensor(m, device=dev)
                for s, m in model.compute_sphere_maps(self.cam_K_np).items()}
        cfg = reference_config(conf)
        pixels, (h, w) = model._strided_pixels(self.stride, dev)
        out, pyramid, at = [], None, None
        with torch.no_grad(), precision(lower):
            for f, p, depth, color in picks:
                if at != f:
                    img = torch.from_numpy(self.frames[f % len(self.frames)]).to(dev)
                    levels = model.encode(img, cam_K, sphere_maps=maps)
                    pyramid, at = model.pyramid_for_item(levels, 0), f
                g = torch.Generator(device=dev).manual_seed(inputs.pose_seed(self.seed, f, p))
                # the draws of the program's render, in its order
                n_uni = RS.row_noise(g, pixels.shape[0], cfg.n_pts_uni, device=dev)
                n_gauss = RS.row_noise(g, pixels.shape[0], cfg.n_pts_gauss, dist="normal",
                                       device=dev)
                r = model.render_rays(pyramid, cam_K, self.poses[p].to(dev), pixels,
                                      ray_chunk=2000, noise_uni=n_uni, noise_gauss=n_gauss)
                out.append({"depth": depth.float(), "color": color.float(),
                            "ref_depth": r["depth"].reshape(h, w).cpu(),
                            "ref_color": r["color"].reshape(h, w, 3).cpu()})
        del model, pyramid
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def pairs(self, picks: List[tuple], lower: Optional[str] = None) -> List[dict]:
        """The program's depth and color of `picks` (the control's, with
        `lower`) beside the reference's, and for a bfloat16 configuration
        the float32 reference's ("f32_depth", "f32_color")."""
        ref = self.reference(picks)
        if lower:
            low = self.reference(picks, lower=lower)
            ref = [{**r, "depth": lo["ref_depth"], "color": lo["ref_color"]}
                   for r, lo in zip(ref, low)]
        if self.f32_side:
            hi = self.reference(picks, conf=in_f32(self.conf))
            ref = [{**r, "f32_depth": h["ref_depth"], "f32_color": h["ref_color"]}
                   for r, h in zip(ref, hi)]
        return ref

    def check(self) -> Dict[str, float]:
        picks = self.sample()
        if not picks:
            return {}
        return compare.sweep_numbers(self.pairs(picks))

    # ------------------------------------------------------------ counts
    def work(self) -> dict:
        """The work of one pose and of one encode, counted from the cell's
        shapes."""
        from benchmark.counts import gather, model_flops, peaks

        cfg = reference_config(self.conf)
        itemsize = 2 if self.conf["dtype"] == "bfloat16" else 4
        enc = model_flops.encoder(self.conf)
        return {"pose_flops": model_flops.render(self.conf, cfg, self.rays_per_pose),
                "encode_flops": enc["flops"],
                "peak_flops": peaks.flops(self.conf["dtype"]),
                "G_pose_s": gather.pose_s(cfg, model_flops.d_latent(self.conf),
                                          self.rays_per_pose, itemsize),
                "G_encode_s": gather.encode_s(enc["sphere_gathers"], itemsize)}
