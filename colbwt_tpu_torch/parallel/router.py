"""Sharded-engine routing — port of colbwt_tpu/parallel/router.py.

The single-card ladder of pipeline/engines.py (pos > mega > per-field),
extended with the wide lane: a wide index (n >= 2**31) goes to the
interval-sharded two-limb engine.  Per-shard memory budgets come from
utils/hbm unless given: the card's budget split over the most shards the
process keeps on one card (ip of them in a mesh over ["cuda:0"] * ip).

| index | engine | module |
|---|---|---|
| narrow, pos tables fit per-shard | sharded-pos (k chars a sum) | query_sharded_pos |
| narrow, run-split (ff_bound>=2)  | sharded-mega (1 sum a step) | query_sharded_mega |
| narrow fallback                  | per-field sharded           | query_sharded |
| wide (n >= 2**31)                | sharded-mega-wide (limbs)   | query_sharded_mega_wide |
"""

from __future__ import annotations

from colbwt_tpu_torch.models.index import ColPmlIndex
from colbwt_tpu_torch.parallel.mesh import Mesh, resolve_mesh
from colbwt_tpu_torch.utils.hbm import resolve_pos_budget


def choose_sharded_engine(index: ColPmlIndex, ip: int,
                          hbm_budget_bytes: int | None = None,
                          device=None) -> str:
    """The engine for `index` at `ip` shards; the budget defaults to
    `device`'s (utils/hbm.resolve_pos_budget; device default cuda)."""
    from colbwt_tpu_torch.parallel.query_sharded_pos import choose_k_sharded

    if index.wide:
        if index.ff_bound < 2:
            raise ValueError("wide index lacks run splitting (ff_bound < 2);"
                             " rebuild with ColPmlIndex.build")
        return "sharded-mega-wide"
    if hbm_budget_bytes is None:
        hbm_budget_bytes = resolve_pos_budget(0, device)
    if choose_k_sharded(index, ip, hbm_budget_bytes) >= 1:
        return "sharded-pos"
    if index.ff_bound >= 2:
        return "sharded-mega"
    return "sharded"


def shard_budget(mesh: Mesh, hbm_budget_bytes: int | None = None) -> int:
    """The memory budget of one shard: `hbm_budget_bytes` when given, else
    the budget of the mesh's first device (utils/hbm.resolve_pos_budget)
    over the most shards this process keeps on one device."""
    if hbm_budget_bytes is not None:
        return hbm_budget_bytes
    return (resolve_pos_budget(0, mesh.devices()[0])
            // mesh.shards_per_device())


def query_batch_sharded_auto(index: ColPmlIndex, patterns: list[bytes],
                             mesh: Mesh | None = None, dp: int | None = None,
                             ip: int = 1, max_len: int | None = None,
                             hbm_budget_bytes: int | None = None,
                             engine: str | None = None):
    """Route a read batch to the best sharded engine for `index`.

    Returns (pmls, cids, engine_name)."""
    from colbwt_tpu_torch.parallel.query_sharded_pos import choose_k_sharded

    mesh = resolve_mesh(mesh, dp, ip)
    budget = shard_budget(mesh, hbm_budget_bytes)
    name = engine or choose_sharded_engine(index, mesh.ip, budget)
    if name == "sharded-mega-wide":
        from colbwt_tpu_torch.parallel.query_sharded_mega_wide import (
            query_batch_sharded_mega_wide)

        p, c = query_batch_sharded_mega_wide(index, patterns, mesh=mesh,
                                             max_len=max_len)
    elif name == "sharded-pos":
        from colbwt_tpu_torch.parallel.query_sharded_pos import (
            query_batch_sharded_pos)

        # the tables sized to the same budget (None: the engine's default)
        p, c = query_batch_sharded_pos(
            index, patterns, mesh=mesh, max_len=max_len,
            k=choose_k_sharded(index, mesh.ip, budget) or None)
    elif name == "sharded-mega":
        from colbwt_tpu_torch.parallel.query_sharded_mega import (
            query_batch_sharded_mega)

        p, c = query_batch_sharded_mega(index, patterns, mesh=mesh,
                                        max_len=max_len)
    elif name == "sharded":
        from colbwt_tpu_torch.parallel.query_sharded import (
            query_batch_sharded)

        p, c = query_batch_sharded(index, patterns, mesh=mesh,
                                   max_len=max_len)
    else:
        raise ValueError(f"unknown sharded engine {name!r}")
    return p, c, name
