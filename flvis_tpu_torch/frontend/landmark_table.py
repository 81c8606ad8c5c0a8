"""Fixed-capacity structure-of-arrays landmark table
(port of flvis_tpu/frontend/landmark_table.py).

Slots keep the reference's lifecycle: detect → fill an empty slot → tracked
each frame → killed by a gate (active = False) → reused.  Live slots never
move, so landmark ids stay with their slot.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.se3 import SE3


@dataclasses.dataclass(frozen=True)
class LandmarkTable:
    uv: torch.Tensor          # (N, 2) current pixel position in cam0
    p_w: torch.Tensor         # (N, 3) world position (valid iff has_3d)
    has_3d: torch.Tensor      # (N,) bool
    active: torch.Tensor      # (N,) bool — slot occupied
    inlier: torch.Tensor      # (N,) bool — survived this frame's gates
    age: torch.Tensor         # (N,) int32 frames tracked
    lm_id: torch.Tensor       # (N,) int32 global landmark id (-1 = empty)
    ur: torch.Tensor          # (N,) right-image u of the latest stereo match
    ur_ok: torch.Tensor       # (N,) bool — fresh stereo measurement this frame
    z_pend: torch.Tensor      # (N,) pending first depth measurement
    pend_ok: torch.Tensor     # (N,) bool
    rej_count: torch.Tensor   # (N,) int32 consecutive innovation rejections
    obs0_uv: torch.Tensor     # (N, 2) first observation
    obs0_q: torch.Tensor      # (N, 4) T_c_w quaternion at first observation
    obs0_t: torch.Tensor      # (N, 3)

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]

    def obs0_pose(self) -> SE3:
        return SE3(self.obs0_q, self.obs0_t)


def empty(num_slots: int, *, device, dtype=torch.float32) -> LandmarkTable:
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    q0 = z(num_slots, 4)
    q0[:, 0].fill_(1.0)
    return LandmarkTable(
        uv=z(num_slots, 2), p_w=z(num_slots, 3),
        has_3d=z(num_slots, dt=torch.bool), active=z(num_slots, dt=torch.bool),
        inlier=z(num_slots, dt=torch.bool), age=z(num_slots, dt=torch.int32),
        lm_id=torch.full((num_slots,), -1, dtype=torch.int32, device=device),
        ur=z(num_slots), ur_ok=z(num_slots, dt=torch.bool),
        z_pend=z(num_slots), pend_ok=z(num_slots, dt=torch.bool),
        rej_count=z(num_slots, dt=torch.int32),
        obs0_uv=z(num_slots, 2), obs0_q=q0, obs0_t=z(num_slots, 3),
    )


def scatter_rows(dst, idx, src):
    """dst with rows idx set from src, where idx == len(dst) is a dump row:
    the dump row absorbs every unused (possibly duplicate) index and is
    dropped, so real rows are written at most once."""
    pad = torch.zeros((1,) + dst.shape[1:], dtype=dst.dtype, device=dst.device)
    out = torch.cat([dst, pad], 0)
    out[idx] = src.to(dst.dtype).expand((idx.shape[0],) + dst.shape[1:])
    return out[:-1]


def free_slot_order(occupied):
    """Indices of the free slots first, in increasing order, then the
    occupied ones: a fixed-size, sync-free stand-in for
    jnp.nonzero(~occupied, size=n) (entries past the free count are never
    read by the callers)."""
    return torch.argsort(occupied.to(torch.int8), stable=True)


def fill_new_detections(table: LandmarkTable, cand_uv, cand_valid, T_c_w: SE3,
                        next_id):
    """The j-th valid candidate goes into the j-th empty slot.  Returns the
    updated table and the new next_id counter."""
    n = table.capacity
    m = cand_uv.shape[0]
    num_empty = torch.sum(~table.active)
    cand_rank = torch.cumsum(cand_valid.to(torch.int64), 0) - 1
    take = cand_valid & (cand_rank < num_empty)
    empty_slots = free_slot_order(table.active)
    slot_for_cand = torch.where(take, empty_slots[torch.clamp(cand_rank, 0, n - 1)], n)

    def sc(dst, src):
        return scatter_rows(dst, slot_for_cand, src)

    dev = cand_uv.device
    zf = torch.zeros((), dtype=table.uv.dtype, device=dev)
    f = torch.zeros((), dtype=torch.bool, device=dev)
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    new_ids = (next_id + cand_rank).to(torch.int32)
    updated = LandmarkTable(
        uv=sc(table.uv, cand_uv),
        p_w=sc(table.p_w, zf),
        has_3d=sc(table.has_3d, f),
        active=sc(table.active, ~f),
        inlier=sc(table.inlier, ~f),
        age=sc(table.age, i0),
        lm_id=sc(table.lm_id, new_ids),
        ur=sc(table.ur, zf),
        ur_ok=sc(table.ur_ok, f),
        z_pend=sc(table.z_pend, zf),
        pend_ok=sc(table.pend_ok, f),
        rej_count=sc(table.rej_count, i0),
        obs0_uv=sc(table.obs0_uv, cand_uv),
        obs0_q=sc(table.obs0_q, T_c_w.q.expand(m, 4)),
        obs0_t=sc(table.obs0_t, T_c_w.t.expand(m, 3)),
    )
    return updated, (next_id + torch.sum(take)).to(torch.int32)


def kill(table: LandmarkTable, dead_mask) -> LandmarkTable:
    keep = table.active & ~dead_mask
    return dataclasses.replace(table, active=keep, inlier=table.inlier & keep)


def num_active(table: LandmarkTable):
    return torch.sum(table.active)


def num_tracked_3d(table: LandmarkTable):
    return torch.sum(table.active & table.has_3d & table.inlier)
