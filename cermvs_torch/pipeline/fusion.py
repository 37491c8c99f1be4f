"""Point-cloud fusion with an adaptive geometric-consistency threshold, on
one device or over the ranks of a process group.

For every reference view and each of its sources, the reference depth is
projected into the source, the source depth is sampled there, and the
sample is projected back (``_consistency``, batched over reference views
and sources). A source passes level i = 2..10 when the reprojection lands
within ``i / thre1`` pixels and its depth within ``i / thre2`` relative,
``thre1 = 4 * 10^t`` and ``thre2 = 1300 * 10^t``:

  * a pixel is kept if >= i sources pass level i for some i (or every
    source passes level 10);
  * its fused depth is (sum of the level-10 reprojected depths + the
    reference depth) / (level-10 vote count + 1).

A 10-step bisection over t in [-2, 2] moves the threshold until the mean
kept share across views reaches ``glb`` (0.25 by default); the last step's
masks are written as PNGs and its points as ``result.ply``.

Memory: by default the scene's depth, intrinsic and extrinsic stacks live
on the device and each batch of reference views gathers its maps by index.
With ``stream=True`` (or when the depth stack exceeds
``stream_above_bytes``) the stacks stay in host memory and each batch's
(reference, sources) maps are uploaded, so device memory is O(view_batch x
sources x H x W). ``view_batch=0`` runs one reference view at a time.

Several processes (``mesh``, or ``multihost`` under an initialised
process group of several ranks): the reference views of each group are
dealt round robin over the ranks, and in every step of the bisection the
ranks all-gather ``[sum of kept shares, count]`` so that every rank takes
the same global threshold; each rank writes ``result.part{rank}.ply``, and
after a barrier rank 0 merges the parts into ``result.ply``; an exit
barrier follows, so every rank may read it. ``fusion(mesh=)`` means the
ranks of that mesh: the port runs one process per device, so this is the
JAX package's ref-view batch sharded over a mesh in PyTorch's form.

The host side (reading and resizing the depth maps, aligning the images,
emitting points) is the JAX package's numpy and cv2 code, so both write the
same files from the same maps; the device side is torch ops in fp32 in the
same order.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import List

import cv2
import numpy as np
import torch

from cermvs_torch.config import configurable
from cermvs_torch.io.pfm import read_pfm
from cermvs_torch.io.ply import read_ply, write_ply
from cermvs_torch.ops.sampling import bilinear_sample
from cermvs_torch.parallel import mesh as pmesh


def _hom(xyz):
    """(..., n, P) -> (..., n + 1, P): a row of ones appended."""
    return torch.cat([xyz, torch.ones_like(xyz[..., :1, :])], dim=-2)


def _consistency(ref_depth, ref_K, ref_E, src_depth, src_K, src_E, thre1,
                 thre2):
    """Two-way reprojection check of B reference views against S sources
    each. ref_depth (B, H, W), ref_K (B, 3, 3), ref_E (B, 4, 4); src_depth
    (B, S, H, W), src_K (B, S, 3, 3), src_E (B, S, 4, 4); thre1, thre2
    0-dim fp32 tensors. Returns the level masks (B, S, 9, H, W) and the
    reprojected depths (B, S, H, W), zero where level 10 fails."""
    B, S, H, W = src_depth.shape
    dev = ref_depth.device
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    pix = torch.stack([x, y, torch.ones_like(x)], 0).reshape(3, H * W)

    xyz_ref = torch.linalg.inv(ref_K) @ (pix * ref_depth.reshape(B, 1, -1))
    rel = src_E @ torch.linalg.inv(ref_E)[:, None]
    xyz_src = (rel @ _hom(xyz_ref)[:, None])[..., :3, :]      # (B, S, 3, P)
    K_xyz = src_K @ xyz_src
    xy_src = K_xyz[..., :2, :] / K_xyz[..., 2:3, :]

    coords = xy_src.transpose(-1, -2).reshape(B, S, H, W, 2)
    sampled = torch.stack([
        torch.stack([bilinear_sample(src_depth[b, s, :, :, None],
                                     coords[b, s])[..., 0]
                     for s in range(S)]) for b in range(B)])

    xyz_src2 = torch.linalg.inv(src_K) @ (_hom(xy_src)
                                          * sampled.reshape(B, S, 1, -1))
    rel_back = ref_E[:, None] @ torch.linalg.inv(src_E)
    xyz_rp = (rel_back @ _hom(xyz_src2))[..., :3, :]
    depth_rp = xyz_rp[..., 2, :].reshape(B, S, H, W)
    K_rp = ref_K[:, None] @ xyz_rp
    xy_rp = K_rp[..., :2, :] / K_rp[..., 2:3, :]

    dist = torch.sqrt((xy_rp[..., 0, :].reshape(B, S, H, W) - x) ** 2
                      + (xy_rp[..., 1, :].reshape(B, S, H, W) - y) ** 2)
    rel_diff = (depth_rp - ref_depth[:, None]).abs() / ref_depth[:, None]

    levels = torch.arange(2, 11, dtype=torch.float32, device=dev)[:, None,
                                                                  None]
    masks = ((dist[:, :, None] < levels / thre1)
             & (rel_diff[:, :, None] < levels / thre2))
    depth_rp = torch.where(masks[:, :, -1], depth_rp,
                           torch.zeros_like(depth_rp))
    return masks, depth_rp


def _fuse_views(ref_depth, ref_K, ref_E, src_depth, src_K, src_E, thre1,
                thre2):
    """Votes of B reference views: (geo_mask (B, H, W) bool, fused depth
    (B, H, W), kept share (B,))."""
    n_src = src_depth.shape[1]
    masks, depth_rp = _consistency(ref_depth, ref_K, ref_E, src_depth, src_K,
                                   src_E, thre1, thre2)
    vote = masks.to(torch.int32).sum(dim=1)          # (B, 9, H, W)
    geo_sum10 = vote[:, -1]
    levels = torch.arange(2, 11, device=vote.device)[:, None, None]
    geo_mask = (geo_sum10 >= 1 + n_src) | (vote >= levels).any(dim=1)
    fused = (depth_rp.sum(dim=1) + ref_depth) / (geo_sum10 + 1)
    return geo_mask, fused, geo_mask.float().mean(dim=(1, 2))


def align_image_to_depth(ref_img, depth, rescale, intrinsics, extrinsics):
    """Resize and crop the RGB image onto the depth map's grid, fixing the
    intrinsics.

    ref_img: (H, W, 3) in [0, 1]; depth: (h, w) at the inference resolution
    (already rescaled by the caller). Returns (img, intrinsics, extrinsics).
    """
    intrinsics = np.array(intrinsics, np.float64)
    extrinsics = np.array(extrinsics, np.float64)
    scale = float(depth.shape[0]) / ref_img.shape[0]
    flag = 0
    if depth.shape[1] / ref_img.shape[1] > scale:
        scale = float(depth.shape[1]) / ref_img.shape[1]
        flag = 1
    img = cv2.resize(ref_img, None, fx=scale, fy=scale,
                     interpolation=cv2.INTER_LINEAR)
    if flag == 0:
        index = int(math.ceil((img.shape[1] - depth.shape[1]) / 2))
        img = img[:, index : depth.shape[1] + index, :]
    else:
        index = int(math.ceil((img.shape[0] - depth.shape[0]) / 2))
        img = img[index : img.shape[0] - index, :, :]
    intrinsics[:2, :] *= scale
    if flag == 0:
        intrinsics[0, 2] -= index
    else:
        intrinsics[1, 2] -= index
    return img, intrinsics, extrinsics


def _fusion_group(mesh, multihost: bool):
    """The process group fusion shares its views over (None: alone): the
    ranks of ``mesh``, else with ``multihost`` every rank of an initialised
    group of several."""
    if mesh is not None:
        return pmesh.mesh_group(mesh)
    if multihost and pmesh.world_size(pmesh.world()) > 1:
        return pmesh.world()
    return None


@configurable("fusion")
def fusion(data_loader, output_folder, suffix="", glb: float = 0.25,
           rescale: float = 1, tot_iter: int = 10, mesh=None,
           view_batch: int = 0, stream: bool = False,
           stream_above_bytes: int = 4 << 30, multihost: bool = True,
           device="cuda"):
    """Adaptive-threshold fusion of the depth maps
    ``{output_folder}/depths/{ref}{suffix}.pfm`` of every view of
    ``data_loader`` into ``{output_folder}/result.ply`` (returned), with
    mask PNGs under ``mask/``. ``view_batch > 0`` runs that many reference
    views per batch. ``mesh`` (a ``(data, view)`` DeviceMesh) or
    ``multihost`` with several ranks: the views are shared by the ranks
    (module docstring); every rank reads every depth map and returns the
    path of the merged cloud. A mesh of another kind raises
    ``NotImplementedError``."""
    group = _fusion_group(mesh, multihost)
    pc, pid = pmesh.world_size(group), pmesh.rank(group)
    dev = pmesh.local_device(device)
    output_folder = Path(output_folder)

    all_images: List[np.ndarray] = []
    all_depths: List[np.ndarray] = []
    all_intrinsics: List[np.ndarray] = []
    all_extrinsics: List[np.ndarray] = []
    refid_to_index = {}
    pair_data = []

    for i, (images, extrinsics, intrinsics, image_names, _) in enumerate(
            data_loader):
        refid = image_names[0]
        refid_to_index[refid] = i
        pair_data.append((refid, list(image_names[1:])))

        ref_img = images[0] / 255.0
        depth = read_pfm(output_folder / "depths" / f"{refid}{suffix}.pfm")
        h, w = depth.shape
        depth = cv2.resize(depth, (int(w * rescale), int(h * rescale)))
        img, K, E = align_image_to_depth(
            ref_img, depth, rescale, intrinsics[0], extrinsics[0])

        if all_depths and depth.shape != all_depths[0].shape:
            h0, w0 = all_depths[0].shape
            canvas = np.zeros((h0, w0), depth.dtype)
            sh, sw = min(h0, depth.shape[0]), min(w0, depth.shape[1])
            canvas[:sh, :sw] = depth[:sh, :sw]
            depth = canvas
            canvas = np.zeros_like(all_images[0])
            sh = min(canvas.shape[0], img.shape[0])
            sw = min(canvas.shape[1], img.shape[1])
            canvas[:sh, :sw] = img[:sh, :sw]
            img = canvas
        all_images.append(img)
        all_depths.append(depth.astype(np.float32))
        all_intrinsics.append(K.astype(np.float32))
        all_extrinsics.append(E.astype(np.float32))

    depths_np = np.stack(all_depths)
    Ks_np = np.stack(all_intrinsics)
    Es_np = np.stack(all_extrinsics)
    stream = stream or depths_np.nbytes > stream_above_bytes
    if stream and view_batch <= 0:
        view_batch = 8
    if not stream:
        depths, Ks, Es = (torch.from_numpy(a).to(dev)
                          for a in (depths_np, Ks_np, Es_np))

    def upload(ids):
        """One batch's maps: uploaded from the host stacks when streaming,
        gathered on the device otherwise."""
        if stream:
            return tuple(torch.from_numpy(a[ids]).to(dev)
                         for a in (depths_np, Ks_np, Es_np))
        idx = torch.from_numpy(ids).to(dev)
        return depths[idx], Ks[idx], Es[idx]

    thre_left, thre_right = -2.0, 2.0
    vertexs, vertex_colors = [], []

    # reference views grouped by source count: one batch shape per group
    groups = {}
    for refid, srcids in pair_data:
        ref = refid_to_index[refid]
        srcs = [refid_to_index[x] for x in srcids]
        assert srcs, "reference view needs at least one source"
        groups.setdefault(len(srcs), []).append((ref, srcs))
    if pc > 1:
        # each group's reference views dealt round robin over the ranks;
        # the threshold search stays global (below)
        groups = {k: v[pid::pc] for k, v in groups.items()}
        groups = {k: v for k, v in groups.items() if v}

    def emit_points(ref, geo_mask, fused_depth):
        os.makedirs(output_folder / "mask", exist_ok=True)
        cv2.imwrite(str(output_folder / "mask" / f"{ref}{suffix}.png"),
                    geo_mask.astype(np.uint8) * 255)
        print(f"ref-view {ref}, mask: {geo_mask.mean():.4f}")
        ys, xs = np.where(geo_mask)
        d = fused_depth[ys, xs]
        color = all_images[ref][ys, xs]
        xyz_ref = np.linalg.inv(all_intrinsics[ref]) @ (
            np.vstack([xs, ys, np.ones_like(xs)]) * d)
        xyz_world = (np.linalg.inv(all_extrinsics[ref]) @ np.vstack(
            [xyz_ref, np.ones_like(xs)]))[:3]
        vertexs.append(xyz_world.T.astype(np.float32))
        vertex_colors.append((color * 255).astype(np.uint8))

    for it in range(tot_iter):
        thre = (thre_left + thre_right) / 2
        thre1 = torch.tensor(10.0 ** thre * 4.0, dtype=torch.float32,
                             device=dev)
        thre2 = torch.tensor(10.0 ** thre * 1300.0, dtype=torch.float32,
                             device=dev)
        mask_ratios = []
        last = it == tot_iter - 1

        for items in groups.values():
            bsz = max(1, view_batch)
            for s in range(0, len(items), bsz):
                chunk = items[s : s + bsz]
                ref_ids = np.asarray([r for r, _ in chunk], np.int64)
                src_ids = np.asarray([ss for _, ss in chunk], np.int64)
                ref_d, ref_K, ref_E = upload(ref_ids)
                src_d, src_K, src_E = upload(src_ids)
                with torch.no_grad():
                    gm, fd, ratios = _fuse_views(ref_d, ref_K, ref_E, src_d,
                                                 src_K, src_E, thre1, thre2)
                mask_ratios.extend(float(r) for r in ratios.cpu().numpy())
                if last:
                    gm, fd = gm.cpu().numpy(), fd.cpu().numpy()
                    for k, (ref, _) in enumerate(chunk):
                        emit_points(ref, gm[k], fd[k])

        if pc > 1:
            # the mean over every rank's views: each rank updates the same
            # threshold
            v = pmesh.process_allgather(np.asarray(
                [float(np.sum(mask_ratios)), float(len(mask_ratios))],
                np.float64), group)
            mean_mask = float(v[:, 0].sum() / max(v[:, 1].sum(), 1.0))
        else:
            mean_mask = float(np.mean(mask_ratios))
        print(f"iter {it}: thre={10 ** thre:.5f} mean_mask={mean_mask:.4f}")
        if mean_mask >= glb:
            thre_left = thre
        else:
            thre_right = thre

    xyz = (np.concatenate(vertexs, axis=0) if vertexs
           else np.zeros((0, 3), np.float32))
    rgb = (np.concatenate(vertex_colors, axis=0) if vertex_colors
           else np.zeros((0, 3), np.uint8))
    out = output_folder / "result.ply"
    if pc > 1:
        write_ply(output_folder / f"result.part{pid}.ply", xyz, rgb)
        pmesh.barrier(group)  # every part is written before the merge
        if pid == 0:
            parts = [read_ply(output_folder / f"result.part{q}.ply")
                     for q in range(pc)]
            write_ply(out, np.concatenate([a for a, _ in parts]),
                      np.concatenate([b for _, b in parts]))
            print("saving the final model to", out)
        pmesh.barrier(group)  # callers on every rank may read result.ply
        return out
    write_ply(out, xyz, rgb)
    print("saving the final model to", out)
    return out
