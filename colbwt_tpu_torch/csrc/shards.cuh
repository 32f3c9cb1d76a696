// The owner selection of an ip-sharded table, shared by the one-launch
// masked gather (query_sharded.cu) and the sharded chunk scan
// (query_mega.cu).
//
// A table splits over "ip" into contiguous blocks of L rows: shard i owns
// global rows [i*L, (i+1)*L).  The shards that one card holds are handed to
// a kernel as a device array of 2*ip int64 values, the shards' base
// addresses (0 where another card holds the shard), then their row counts.

#pragma once

#include <stdint.h>

namespace colbwt {

struct ShardRow {
  const void* base;  // nullptr: no shard on this card owns the row
  int64_t local;     // the row within the owning shard
  int64_t rows;      // the owning shard's row count
};

// The shard that owns global row g: one 32-bit division a lane, two reads
// of the small shard array (cached after the first lane).  A row past every
// shard (g < 0 or g >= ip*L) and a row of a shard on another card read as
// zeros, as JAX's masked take summed over "ip".
__device__ __forceinline__ ShardRow shard_row(
    const long long* __restrict__ tab, int ip, int64_t L, int32_t g) {
  ShardRow o{nullptr, 0, 0};
  if (g < 0 || static_cast<int64_t>(g) >= ip * L) return o;
  const int i = L > INT32_MAX ? 0
                              : static_cast<int>(static_cast<uint32_t>(g) /
                                                 static_cast<uint32_t>(L));
  o.base = reinterpret_cast<const void*>(__ldg(tab + i));
  o.local = g - static_cast<int64_t>(i) * L;
  o.rows = __ldg(tab + ip + i);
  return o;
}

}  // namespace colbwt
