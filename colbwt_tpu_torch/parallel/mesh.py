"""Device mesh, sharding layouts and the masked gather — port of
colbwt_tpu/parallel/mesh.py.

The mesh is a (dp, ip) grid, as in the JAX package:

- axis "dp": data parallel over reads; every per-read array is split by
  rows of the batch, and reads never communicate;
- axis "ip": index parallel over runs; a table is split into contiguous
  row blocks, every table access is a gather masked to the shard that owns
  the row (0 elsewhere), and the shards' gathers are summed over "ip" (the
  JAX package's psum).  With ip = 1 the one shard owns every row and no
  sum runs.

It has two forms, which compute the same thing:

- one process: `make_mesh(dp, ip, devices)` arranges an explicit device
  list, devices[: dp*ip] reshaped (dp, ip).  A device may repeat:
  ["cpu"] * 8 is the counterpart of the JAX tests' 8-device virtual CPU
  mesh, ["cuda:0"] * ip holds ip shards as separate tensors on one card.
  The process computes every dp row; a gather is one fetch a card for the
  row's shards that card holds, and the sum over "ip" the sum of the cards'
  outputs on the row's device (its ip-0 device).
- one process a rank: with torch.distributed initialised at world size
  dp*ip and no device list, `make_mesh` takes
  torch.distributed.device_mesh.init_device_mesh over ("dp", "ip").  A rank
  holds one cell: shard i of each table and row d of the reads.  The sum
  is an all_reduce over the rank's ip subgroup (NCCL for CUDA tensors,
  gloo for CPU tensors, as the process group was made), and each row's
  outputs are all-gathered over the dp subgroup, so every rank returns the
  whole batch.

`sharded_fetch` is the masked gather of all the shards of a row that one
card holds, one CUDA kernel launch (csrc/query_sharded.cu) with its plain
PyTorch version `sharded_fetch_ref` beside it; it serves K13a, K13b, K13c
and K13e.  `Fetch` is the same call prepared once for buffers that a
route rewrites between steps, and `Mesh.gatherer` the summed gather so
prepared.  A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.models.tensors import to_device
from colbwt_tpu_torch.ops import _kernels as K
from colbwt_tpu_torch.utils.device import resolve_device


def _shard_fetch_ref(table: torch.Tensor, g: torch.Tensor, s,
                     block_start: int, L: int, stride: int) -> torch.Tensor:
    """One shard's masked gather, as the JAX programs write it: the local
    index clipped, then masked."""
    j = g.long() - block_start
    ok = (j >= 0) & (j < L)
    local = j.clamp(0, L - 1)
    if s is not None:
        local = s.long() * stride + local
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return torch.where(ok[:, None], rows, 0)


def sharded_fetch_ref(shards: list, g: torch.Tensor, s, L: int,
                      stride: int = 0, out=None) -> torch.Tensor:
    """Plain PyTorch version of `sharded_fetch`: the sum over the card's
    shards of each shard's masked gather."""
    total = None
    for i, table in enumerate(shards):
        if table is not None:
            part = _shard_fetch_ref(table, g, s, i * L, L, stride)
            total = part if total is None else total + part
    if out is None:
        return total
    return out.copy_(total)


@functools.lru_cache(maxsize=256)
def _pointer_array(device: str, bases: tuple, rows: tuple) -> torch.Tensor:
    """The kernels' (2·ip,) int64 shard array: bases, then row counts; made
    at a table's first fetch on a card and kept (keyed by the addresses)."""
    return torch.tensor(bases + rows, dtype=torch.int64, device=device)


def shard_pointers(shards: list, dev: torch.device, W: int) -> torch.Tensor:
    """Validate the card's shards of one table ((rows, W) int32, W in {2, 8,
    16}, aligned for the kernels' 8- or 16-byte loads; None where another
    card holds the shard) and return their device shard array."""
    if W not in (2, 8, 16):
        raise ValueError(f"sharded tables must be 2, 8 or 16 wide, got {W}")
    bases, rows = [], []
    for i, t in enumerate(shards):
        if t is None:
            bases.append(0)
            rows.append(0)
            continue
        K.require(t, f"shard {i}", torch.int32, dev)
        K.require_aligned(t, f"shard {i}", 8 if W == 2 else 16)
        if t.dim() != 2 or t.shape[1] != W or t.shape[0] < 1:
            raise ValueError(f"shard {i} must be (rows >= 1, {W}), got "
                             f"{tuple(t.shape)}")
        bases.append(t.data_ptr())
        rows.append(t.shape[0])
    return _pointer_array(str(dev), tuple(bases), tuple(rows))


class Fetch:
    """`sharded_fetch` prepared once for fixed shards, g, s and out (a
    route's buffers, rewritten in place between calls): the arguments are
    validated here, as `sharded_fetch` validates them; each call is one
    launch (the plain version on the CPU) and returns out."""

    def __init__(self, shards: list, g: torch.Tensor, s, L: int,
                 stride: int = 0, out: torch.Tensor | None = None):
        held = [t for t in shards if t is not None]
        if not held:
            raise ValueError("sharded_fetch needs at least one shard")
        dev = held[0].device
        B, W = g.shape[0], held[0].shape[-1]
        tab = shard_pointers(shards, dev, W)
        K.require(g, "g", torch.int32, dev)
        if g.dim() != 1:
            raise ValueError("g must be (B,)")
        if s is not None:
            K.require(s, "s", torch.int32, dev)
            if s.shape != (B,):
                raise ValueError(f"s must have shape ({B},)")
        if out is None:
            out = torch.empty((B, W), dtype=torch.int32, device=dev)
        K.require(out, "out", torch.int32, dev)
        if out.shape != (B, W):
            raise ValueError(f"out must have shape ({B}, {W})")
        self._args = (shards, g, s, L, stride, out)
        self._plain = dev.type == "cpu"
        self._launch = None
        if not self._plain and B:
            self._launch = K.Launcher(
                dev, "colbwt_sharded_fetch", "sharded_fetch", tab.data_ptr(),
                len(shards), int(L), W, g.data_ptr(),
                None if s is None else s.data_ptr(), B, int(stride),
                out.data_ptr(), K.stream_handle(dev), keep=tab)

    def args(self) -> tuple:
        """`sharded_fetch`'s arguments."""
        return self._args

    def __call__(self) -> torch.Tensor:
        if self._plain:
            return sharded_fetch_ref(*self._args)
        if self._launch is not None:
            self._launch()
        return self._args[5]


def sharded_fetch(shards: list, g: torch.Tensor, s, L: int, stride: int = 0,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """The masked gather of the ip shards one card holds, in one launch
    (replaces the masked `jnp.take` summed over "ip" of
    colbwt_tpu/parallel/query_sharded.py:33 _local_gathers and its
    counterparts in query_sharded_mega.py:62, query_sharded_mega_wide.py:117
    and query_sharded_pos.py:169).  shards[i] is shard i's (rows, W) int32
    block on this card (None where another card holds it); shard i owns
    global rows [i·L, (i+1)·L).  Lane b's owner i reads its local row
    s[b]·stride + g[b] - i·L (s None: selector 0), clamped as
    jnp.take(mode="clip"); a lane that no shard of this card owns reads 0.
    Writes `out` when given, else a new tensor; returns (B, W) int32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel (one
    call of a `Fetch`)."""
    return Fetch(shards, g, s, L, stride, out)()


class Mesh:
    """A (dp, ip) grid of devices as one process sees it; see the module
    docstring for its two forms."""

    def __init__(self, dp: int, ip: int, grid=None, device=None,
                 device_mesh=None, coord=None):
        self.dp, self.ip = dp, ip
        self._grid = grid            # one process: (dp, ip) devices
        self._device = device        # one process a rank: this rank's device
        self._dm = device_mesh
        self._coord = coord          # this rank's (d, i)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "ip": self.ip}

    def close(self) -> None:
        """Drop the mesh's devices and its device mesh, whose dp and ip
        process groups (and their worker threads) live as long as it is
        referenced; a closed mesh computes nothing."""
        self._grid = self._device = self._dm = self._coord = None

    @property
    def distributed(self) -> bool:
        return self._dm is not None

    def rows(self) -> list[int]:
        """The dp rows this process computes."""
        return [self._coord[0]] if self._dm else list(range(self.dp))

    def row_cells(self, d: int) -> list[tuple[int, torch.device]]:
        """(ip index, device) of the shards this process holds in row d."""
        if self._dm:
            return [(self._coord[1], self._device)]
        return [(i, self._grid[d][i]) for i in range(self.ip)]

    def row_device(self, d: int) -> torch.device:
        return self._device if self._dm else self._grid[d][0]

    def devices(self) -> list[torch.device]:
        """The distinct devices this process uses."""
        out = {}
        for d in self.rows():
            for _, dev in self.row_cells(d):
                out.setdefault(str(dev), dev)
        return list(out.values())

    def shards_per_device(self) -> int:
        """The most ip shards this process keeps on one device (`shard`
        holds one copy per (device, shard))."""
        held = {}
        for d in self.rows():
            for i, dev in self.row_cells(d):
                held.setdefault(str(dev), set()).add(i)
        return max(len(v) for v in held.values())

    def shard(self, make) -> dict:
        """{(str(device), i): make(i, device)} for the shards this process
        holds, one copy per (device, shard): shard i of a table is the same
        tensor in every dp row on one device."""
        out = {}
        for d in self.rows():
            for i, dev in self.row_cells(d):
                if (str(dev), i) not in out:
                    out[(str(dev), i)] = make(i, dev)
        return out

    def replicate(self, make) -> dict:
        """{str(device): make(device)}, one replica per device used."""
        return {str(dev): make(dev) for dev in self.devices()}

    def card_shards(self, shards: dict, d: int
                    ) -> list[tuple[torch.device, list]]:
        """Row d's shards of a table grouped by card: [(device, [shard i's
        tensor on that device, or None])], the row's device first."""
        cards = {}
        for i, dev in self.row_cells(d):
            cards.setdefault(str(dev), (dev, [None] * self.ip))[1][i] = \
                shards[(str(dev), i)]
        return list(cards.values())

    def psum(self, parts: list[torch.Tensor], d: int) -> torch.Tensor:
        """The sum over "ip" of row d's per-card outputs, into the first
        (on the row's device): added here across the cards of one process,
        all-reduced over the ip group across ranks."""
        out = parts[0]
        if self._dm:
            if self.ip > 1:
                dist.all_reduce(out, op=dist.ReduceOp.SUM,
                                group=self._dm.get_group("ip"))
            return out
        for p in parts[1:]:
            out += p.to(out.device)
        return out

    def gather(self, shards: dict, d: int, L: int, g: torch.Tensor, s=None,
               stride: int = 0, out: torch.Tensor | None = None
               ) -> torch.Tensor:
        """Rows of an ip-sharded table at global indices g (shard i holds
        [i·L, (i+1)·L)): one `sharded_fetch` a card, summed over "ip".
        `out` (on the row's device) takes the result when given."""
        return self.gatherer(shards, d, L, g, s, stride, out)()

    def gatherer(self, shards: dict, d: int, L: int, g: torch.Tensor,
                 s=None, stride: int = 0, out: torch.Tensor | None = None):
        """`gather` prepared once for g, s and out, which the caller
        rewrites in place between calls (a route's step loop): one `Fetch`
        a card, validated here, with its copies of g and s on the other
        cards; each call copies g and s there, fetches and sums, and
        returns the sum (in `out`, or a buffer made here)."""
        parts = []
        for j, (dev, tables) in enumerate(self.card_shards(shards, d)):
            gj = g if g.device == dev else torch.empty_like(g, device=dev)
            sj = (s if s is None or s.device == dev
                  else torch.empty_like(s, device=dev))
            parts.append((gj, sj, Fetch(tables, gj, sj, L, stride,
                                        out if j == 0 else None)))

        def fetch() -> torch.Tensor:
            outs = []
            for gj, sj, one in parts:
                if gj is not g:
                    gj.copy_(g)
                if sj is not s:
                    sj.copy_(s)
                outs.append(one())
            return self.psum(outs, d)
        return fetch

    def collect(self, outs: dict) -> list[np.ndarray]:
        """The whole batch's outputs from {d: (tensor, ...)} of the rows
        this process computed, in row order (all-gathered over the dp
        group across ranks)."""
        if self._dm:
            (d,) = outs
            res = []
            for t in outs[d]:
                if self.dp > 1:
                    got = [torch.empty_like(t) for _ in range(self.dp)]
                    dist.all_gather(got, t.contiguous(),
                                    group=self._dm.get_group("dp"))
                    t = torch.cat(got)
                res.append(t.cpu().numpy())
            return res
        n_out = len(next(iter(outs.values())))
        return [torch.cat([outs[d][j].cpu() for d in sorted(outs)]).numpy()
                for j in range(n_out)]


def _world() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def default_devices() -> list[torch.device]:
    """cuda:0 .. cuda:count-1; raises when CUDA is unavailable."""
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(dp: int, ip: int = 1, devices=None) -> Mesh:
    """A (dp, ip) mesh: over `devices` (default cuda:0..count-1) in one
    process, or, with torch.distributed initialised at world size > 1 and
    no device list, over the ranks (one cell each)."""
    if dp < 1 or ip < 1:
        raise ValueError(f"mesh {dp}x{ip}: dp and ip must be >= 1")
    if devices is None and _world() > 1:
        world = _world()
        if dp * ip != world:
            raise ValueError(f"mesh {dp}x{ip} needs {dp * ip} devices, "
                             f"have {world} processes")
        from torch.distributed.device_mesh import init_device_mesh

        # the rank's device follows the backend the group was made with;
        # every rank makes the mesh (its ip and dp groups) together
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        dm = init_device_mesh(dev.type, (dp, ip), mesh_dim_names=("dp", "ip"))
        return Mesh(dp, ip, device=dev, device_mesh=dm,
                    coord=tuple(dm.get_coordinate()))
    devices = (default_devices() if devices is None
               else [resolve_device(x) for x in devices])
    if dp * ip > len(devices):
        raise ValueError(f"mesh {dp}x{ip} needs {dp * ip} devices, "
                         f"have {len(devices)}")
    grid = [[devices[d * ip + i] for i in range(ip)] for d in range(dp)]
    return Mesh(dp, ip, grid=grid)


def resolve_mesh(mesh: Mesh | None, dp: int | None, ip: int) -> Mesh:
    """`mesh`, else a (dp or all devices // ip, ip) mesh over the default
    devices (the ranks, when distributed)."""
    if mesh is not None:
        return mesh
    count = _world() if _world() > 1 else len(default_devices())
    return make_mesh(dp or count // ip, ip)


def pad_rows(index: ColPmlIndex, ip: int) -> dict[str, np.ndarray]:
    """Index fields with the run axis padded to a multiple of ip.

    Padding rows are inert: char = sigma (matches no read char, so no match
    and no jump hit), length = 1, dest = self-loops at the last real run,
    succ = none, pred = the last real pred."""
    r = index.r
    pad = (-r) % ip
    rp = r + pad

    def pad1(a, fill):
        out = np.full((rp,), fill, dtype=np.int32)
        out[:r] = a
        return out

    fields = {
        "char": pad1(index.char, index.sigma),
        "idx": pad1(index.idx, index.n - 1),
        "length": pad1(index.length, 1),
        "dest_interval": pad1(index.dest_interval, r - 1),
        "dest_offset": pad1(index.dest_offset, 0),
        "col_id": pad1(index.col_id, 0),
        "threshold": pad1(index.threshold, 0),
    }
    sig = index.pred_jump.shape[0]
    pj = np.full((sig, rp), -1, dtype=np.int32)
    pj[:, :r] = index.pred_jump
    sj = np.full((sig, rp), r, dtype=np.int32)
    sj[:, :r] = index.succ_jump
    if pad:
        pj[:, r:] = index.pred_jump[:, r - 1][:, None]
    fields["pred_jump"] = pj
    fields["succ_jump"] = sj
    return fields


# the packed run row of the sharded compact engine: the seven fields of
# colbwt_tpu/parallel/query_sharded.py:29 in its order, padded to 32 B
SOA_FIELDS = ("char", "idx", "length", "dest_interval", "dest_offset",
              "col_id", "threshold")
SOA_WIDTH = 8


def shard_index(index: ColPmlIndex, mesh: Mesh) -> dict:
    """Place the index on the mesh, the run axis split over "ip" and every
    shard replicated over "dp": "soa" (r_local, 8) packed run rows
    (SOA_FIELDS, then 0) and "jump" (σ'·r_local, 2) rows [succ, pred] at
    c·r_local + local run, per shard."""
    ip = mesh.ip
    fields = pad_rows(index, ip)
    rp = fields["char"].shape[0]
    rl = rp // ip
    soa = np.zeros((rp, SOA_WIDTH), dtype=np.int32)
    for j, f in enumerate(SOA_FIELDS):
        soa[:, j] = fields[f]
    jump = np.stack([fields["succ_jump"], fields["pred_jump"]], axis=2)
    return {
        "soa": mesh.shard(lambda i, dev: to_device(
            soa[i * rl:(i + 1) * rl], dev)),
        "jump": mesh.shard(lambda i, dev: to_device(
            jump[:, i * rl:(i + 1) * rl].reshape(-1, 2), dev)),
        "n": int(index.n),
        "r": int(index.r),
        "r_padded": rp,
    }


def shard_reads(patterns: np.ndarray, lengths: np.ndarray, mesh: Mesh
                ) -> dict:
    """Split a (B, M) read batch over "dp" (B must divide by dp): {d:
    (uint8 patterns, int32 lengths)} on each computed row's device."""
    dp = mesh.dp
    if patterns.shape[0] % dp:
        raise ValueError(f"batch {patterns.shape[0]} not divisible by dp={dp}")
    bl = patterns.shape[0] // dp
    return {d: (to_device(patterns[d * bl:(d + 1) * bl],
                          mesh.row_device(d), np.uint8),
                to_device(lengths[d * bl:(d + 1) * bl], mesh.row_device(d)))
            for d in mesh.rows()}


def pad_batch(index: ColPmlIndex, patterns: list[bytes], dp: int,
              max_len: int | None) -> tuple[np.ndarray, np.ndarray]:
    """Encode, then pad the batch up to a multiple of dp with empty reads."""
    enc, lens = index.encode_patterns(patterns, max_len)
    pad = (-enc.shape[0]) % dp
    if pad:
        enc = np.concatenate([enc, np.zeros((pad, enc.shape[1]), enc.dtype)])
        lens = np.concatenate([lens, np.zeros((pad,), lens.dtype)])
    return enc, lens


def unpad(pml: np.ndarray, cid: np.ndarray, lens: np.ndarray, B: int
          ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """The first B reads' outputs, each cut to its length."""
    M = pml.shape[1]
    return ([pml[b, M - int(lens[b]):] for b in range(B)],
            [cid[b, M - int(lens[b]):] for b in range(B)])
