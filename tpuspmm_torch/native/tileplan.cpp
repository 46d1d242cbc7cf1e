// Native tile-plan builder for tpuspmm_torch (the port's own copy of
// tpuspmm/native/tileplan.cpp, two-phase entry points only).
//
// C++ twin of tpuspmm_torch/formats/tiles.py::build_tile_plan, with the
// same output bit for bit: group the nonzeros by (row tile, k tile),
// row-tile-major and ascending in k tile, keeping their input order within
// a group (the numpy path's stable argsort), split each group into chunks
// of E slots padded with row = -1 sentinels, give every row tile at least
// one chunk, and pad the chunk count to a multiple of 8.  One sort of
// (key, index) pairs and one linear walk, against numpy's argsort and
// fancy gathers.
//
// Exposed through ctypes (tpuspmm_torch/native/tileplan.py):
//   tile_plan_begin(rows, cols, vals, nnz, m, k, tile_m, tile_k, chunk,
//                   &num_chunks) -> state
//     sorts and groups, returns the padded chunk count for the caller to
//     allocate the output arrays (numpy owns them: nothing is copied out);
//     nullptr when memory runs out.
//   tile_plan_fill(state, num_chunks, rt, kt, first, rows, cols, vals)
//     fills those arrays and frees the state.  rows must hold -1 and
//     cols / vals 0 beforehand: only real slots are written.
//   tile_plan_discard(state)
//     frees a state that will not be filled.
// Row and column indices must lie in [0, m) and [0, k): the caller checks.

#include <algorithm>
#include <cstdint>
#include <new>
#include <utility>
#include <vector>

namespace {
inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

struct PlanState {
  std::vector<int32_t> srow, scol;
  std::vector<float> sval;
  struct Chunk { int32_t rt, kt; int64_t start, len; };
  std::vector<Chunk> chunks;
  int64_t tile_m, tile_k, chunk;
};

PlanState* begin(const int64_t* rows, const int64_t* cols, const float* vals,
                 int64_t nnz, int64_t m, int64_t k, int64_t tile_m,
                 int64_t tile_k, int64_t chunk, int64_t* out_num_chunks) {
  const int64_t nrt = cdiv(m, tile_m);
  const int64_t nkt = cdiv(k, tile_k);
  auto* st = new PlanState();
  st->tile_m = tile_m; st->tile_k = tile_k; st->chunk = chunk;

  // a stable sort by (row tile, k tile): sorting (key, index) pairs, the
  // index breaks ties in input order
  std::vector<std::pair<int64_t, int64_t>> ord(nnz);
  for (int64_t i = 0; i < nnz; ++i)
    ord[i] = {(rows[i] / tile_m) * nkt + cols[i] / tile_k, i};
  std::sort(ord.begin(), ord.end());
  std::vector<int64_t> key(nnz);
  st->srow.resize(nnz); st->scol.resize(nnz); st->sval.resize(nnz);
  for (int64_t i = 0; i < nnz; ++i) {
    key[i] = ord[i].first;
    const int64_t src = ord[i].second;
    st->srow[i] = static_cast<int32_t>(rows[src]);
    st->scol[i] = static_cast<int32_t>(cols[src]);
    st->sval[i] = vals[src];
  }
  ord.clear(); ord.shrink_to_fit();

  std::vector<uint8_t> rt_present(nrt, 0);
  std::vector<PlanState::Chunk> data_chunks;
  int64_t i = 0;
  while (i < nnz) {
    const int64_t gk = key[i];
    int64_t j = i;
    while (j < nnz && key[j] == gk) ++j;
    const int32_t rt = static_cast<int32_t>(gk / nkt);
    const int32_t kt = static_cast<int32_t>(gk % nkt);
    rt_present[rt] = 1;
    for (int64_t s = i; s < j; s += chunk)
      data_chunks.push_back({rt, kt, s, std::min(chunk, j - s)});
    i = j;
  }
  // an empty row tile gets one all-sentinel chunk at k tile 0, in row-tile
  // order (the data chunks are row-tile-major: the key is)
  size_t d = 0;
  for (int64_t rt = 0; rt < nrt; ++rt) {
    if (rt_present[rt]) {
      while (d < data_chunks.size() && data_chunks[d].rt == rt)
        st->chunks.push_back(data_chunks[d++]);
    } else {
      st->chunks.push_back({static_cast<int32_t>(rt), 0, 0, 0});
    }
  }
  const int64_t C = static_cast<int64_t>(st->chunks.size());
  *out_num_chunks = cdiv(std::max<int64_t>(C, 1), 8) * 8;
  return st;
}
}  // namespace

extern "C" {

void* tile_plan_begin(
    const int64_t* rows, const int64_t* cols, const float* vals, int64_t nnz,
    int64_t m, int64_t k, int64_t tile_m, int64_t tile_k, int64_t chunk,
    int64_t* out_num_chunks) {
  try {
    return begin(rows, cols, vals, nnz, m, k, tile_m, tile_k, chunk,
                 out_num_chunks);
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

void tile_plan_fill(void* state, int64_t C_pad,
                    int32_t* rt_o, int32_t* kt_o, int32_t* first_o,
                    int32_t* rows_o, int32_t* cols_o, float* vals_o) {
  auto* st = static_cast<PlanState*>(state);
  const int64_t E = st->chunk;
  const int64_t C = static_cast<int64_t>(st->chunks.size());
  int32_t prev_rt = -1;
  for (int64_t ci = 0; ci < C; ++ci) {
    const auto& c = st->chunks[ci];
    rt_o[ci] = c.rt;
    kt_o[ci] = c.kt;
    first_o[ci] = (c.rt != prev_rt) ? 1 : 0;
    prev_rt = c.rt;
    const int32_t roff = static_cast<int32_t>(c.rt * st->tile_m);
    const int32_t koff = static_cast<int32_t>(c.kt * st->tile_k);
    for (int64_t e = 0; e < c.len; ++e) {
      const int64_t src = c.start + e;
      rows_o[ci * E + e] = st->srow[src] - roff;
      cols_o[ci * E + e] = st->scol[src] - koff;
      vals_o[ci * E + e] = st->sval[src];
    }
  }
  // padding chunks attach to the last row tile with k tile 0, first 0
  const int32_t last_rt = C ? st->chunks[C - 1].rt : 0;
  for (int64_t ci = C; ci < C_pad; ++ci) {
    rt_o[ci] = last_rt;
    kt_o[ci] = 0;
    first_o[ci] = 0;
  }
  delete st;
}

void tile_plan_discard(void* state) { delete static_cast<PlanState*>(state); }

}  // extern "C"
