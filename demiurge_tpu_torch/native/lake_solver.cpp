// Native lake-graph solver for the flow-routing pipeline.
//
// Host-side irregular stages of the reference FlowFilter
// (src/filter/FlowFilter.cpp), which the reference runs on a CPU
// threadpool with recursion:
//   - basin flood fill from each sink through the incoming-neighbor
//     bitmasks            (assignLakeIds,      FlowFilter.cpp:360-398)
//   - lowest-pass (saddle) search between basins
//                          (findAllConnections, FlowFilter.cpp:400-531)
//   - global lowest-pass merge into a drainage forest
//                          (solvingConnections,  FlowFilter.cpp:533-595)
//   - per-basin lake waterheight propagation
//                          (lakefill,            FlowFilter.cpp:651-695)
//
// Exposed as a C ABI for ctypes. Single pass over the grid is O(N); the
// merge is O(P log P) in the number of passes.  Semantics match
// demiurge_tpu_torch/ops/flow.py::solve_lakes_numpy (the reference-shaped
// NumPy implementation), which doubles as the oracle in tests.  Built by
// demiurge_tpu_torch/native/build.py.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <algorithm>
#include <limits>

namespace {

struct Pass {
    float h;
    int64_t from;     // other basin's sink index
    int64_t to;       // attach pixel in this basin
    bool operator>(const Pass& o) const {
        if (h != o.h) return h > o.h;
        if (from != o.from) return from > o.from;
        return to > o.to;
    }
    bool operator<(const Pass& o) const {
        if (h != o.h) return h < o.h;
        if (from != o.from) return from < o.from;
        return to < o.to;
    }
};

// incoming-mask bit -> (dx, dy), matching FlowFilter.cpp:39-75
static const int kBits[8] = {1, 2, 4, 8, 32, 64, 128, 256};
static const int kDx[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
static const int kDy[8] = {-1, -1, -1, 0, 0, 1, 1, 1};

}  // namespace

extern "C" int solve_lakes(const int32_t* mask, const uint8_t* mouth,
                           const float* height, int H, int W, int wrap_x,
                           int32_t* conn_from, int32_t* conn_to,
                           float* conn_h, int32_t* n_conn_out,
                           float* lake_wh) {
    const int64_t N = (int64_t)H * W;

    // ---- collect sinks
    std::vector<int64_t> sinks;
    for (int64_t i = 0; i < N; i++)
        if (mask[i] & 16) sinks.push_back(i);

    // ---- basin flood fill (upstream through incoming bits)
    std::vector<int64_t> basin(N, -1);
    std::vector<int64_t> stack;
    for (int64_t s : sinks) {
        stack.clear();
        stack.push_back(s);
        while (!stack.empty()) {
            int64_t p = stack.back();
            stack.pop_back();
            basin[p] = s;
            int m = mask[p];
            int64_t x = p % W, y = p / W;
            for (int b = 0; b < 8; b++) {
                if (!(m & kBits[b])) continue;
                int64_t nx = x + kDx[b];
                if (wrap_x) nx = (nx + W) % W;
                else if (nx < 0 || nx >= W) continue;
                int64_t ny = y + kDy[b];
                if (ny < 0 || ny >= H) continue;
                stack.push_back(ny * W + nx);
            }
        }
    }

    // ---- lowest passes per basin pair (keyed by target basin)
    // passes[s] = sorted list of candidate passes out of basin s
    std::unordered_map<int64_t, std::vector<Pass>> passes;
    passes.reserve(sinks.size());
    {
        std::unordered_map<int64_t, Pass> newpasses;
        for (int64_t s : sinks) {
            newpasses.clear();
            stack.clear();
            stack.push_back(s);
            while (!stack.empty()) {
                int64_t p = stack.back();
                stack.pop_back();
                int64_t x = p % W, y = p / W;
                float minpass = std::numeric_limits<float>::infinity();
                int64_t nlake_pix = -1;
                for (int b = 0; b < 8; b++) {
                    int64_t nx = x + kDx[b];
                    if (wrap_x) nx = (nx + W) % W;
                    else if (nx < 0 || nx >= W) continue;
                    int64_t ny = y + kDy[b];
                    if (ny < 0 || ny >= H) continue;
                    int64_t n = ny * W + nx;
                    if (basin[n] >= 0 && basin[n] != s) {
                        float bd = height[n];
                        if (bd > 0 && bd < minpass) {
                            minpass = bd;
                            nlake_pix = n;
                        }
                    }
                }
                if (nlake_pix >= 0) {
                    int64_t lid = basin[nlake_pix];
                    if (!mouth[lid]) {  // skip passes into mouth basins
                        float nh = std::max(minpass, height[p]);
                        auto it = newpasses.find(lid);
                        if (it == newpasses.end() || nh < it->second.h)
                            newpasses[lid] = Pass{nh, lid, p};
                    }
                }
                int m = mask[p];
                for (int b = 0; b < 8; b++) {
                    if (!(m & kBits[b])) continue;
                    int64_t nx = x + kDx[b];
                    if (wrap_x) nx = (nx + W) % W;
                    else if (nx < 0 || nx >= W) continue;
                    int64_t ny = y + kDy[b];
                    if (ny < 0 || ny >= H) continue;
                    stack.push_back(ny * W + nx);
                }
            }
            auto& lst = passes[s];
            lst.reserve(newpasses.size());
            for (auto& kv : newpasses) lst.push_back(kv.second);
            std::sort(lst.begin(), lst.end());
        }
    }

    // ---- global merge (solvingConnections)
    std::unordered_set<int64_t> placed;
    std::priority_queue<Pass, std::vector<Pass>, std::greater<Pass>> cand;
    std::unordered_map<int64_t, size_t> cursor;  // next unread pass per basin
    std::unordered_map<int64_t, Pass> conns;     // keyed by attach pixel

    auto push_next = [&](int64_t lake) {
        auto it = passes.find(lake);
        if (it == passes.end()) return;
        size_t& cur = cursor[lake];
        while (cur < it->second.size()) {
            const Pass& c = it->second[cur++];
            if (placed.count(c.from)) continue;
            cand.push(c);
            break;
        }
    };

    for (int64_t s : sinks) {
        if (!mouth[s]) continue;
        placed.insert(s);
        auto it = passes.find(s);
        if (it == passes.end()) continue;
        size_t& cur = cursor[s];
        while (cur < it->second.size()) {
            const Pass& c = it->second[cur++];
            if (placed.count(c.from)) continue;
            // reference as-written: bit 10 of the *index* (FlowFilter.cpp:544)
            if (c.from & (1 << 9)) continue;
            cand.push(c);
            break;
        }
    }

    while (!cand.empty()) {
        Pass p = cand.top();
        cand.pop();
        if (placed.count(p.from)) {
            push_next(basin[p.to]);
        } else {
            placed.insert(p.from);
            conns[p.to] = p;
            push_next(p.from);
            push_next(basin[p.to]);
        }
    }

    // ---- emit connections (sorted by attach pixel, like the numpy impl)
    std::vector<int64_t> keys;
    keys.reserve(conns.size());
    for (auto& kv : conns) keys.push_back(kv.first);
    std::sort(keys.begin(), keys.end());
    int32_t n = 0;
    for (int64_t k : keys) {
        const Pass& p = conns[k];
        conn_from[n] = (int32_t)p.from;
        conn_to[n] = (int32_t)p.to;
        conn_h[n] = p.h;
        n++;
    }
    *n_conn_out = n;

    // ---- waterheights (lakefill): propagate along placed connections
    for (int64_t i = 0; i < N; i++) lake_wh[i] = std::nanf("");
    std::unordered_map<int64_t, std::vector<const Pass*>> by_basin;
    for (auto& kv : conns) by_basin[basin[kv.first]].push_back(&kv.second);
    std::vector<std::pair<int64_t, float>> st2;
    for (int64_t s : sinks)
        if (mouth[s]) st2.push_back({s, 0.0f});
    while (!st2.empty()) {
        auto [s, wh] = st2.back();
        st2.pop_back();
        lake_wh[s] = wh;
        auto it = by_basin.find(s);
        if (it != by_basin.end())
            for (const Pass* p : it->second)
                st2.push_back({p->from, wh > p->h ? wh : p->h});
    }
    return 0;
}
