// Native core for detection's multi-threshold deblending merge.
//
// A copy of the JAX package's debvader_tpu/runtime/segmerge.cpp: the code
// below this header is byte for byte the same, so the two packages merge
// and deblend identically.  Only this header differs.
//
// ops/detection.py::_merge_labels_coo applies SExtractor's quantized
// deblending criterion (the reference's sep.extract deblend_nthresh /
// deblend_cont parameters, detect/detection.py:20-21 of the reference) to
// the watershed segments: weakest-peak-first, each segment merges into its
// brightest-saddle neighbor unless at least one quantization level
// separates peak from saddle AND its flux clears the contrast floor.  The
// algorithm is inherently sequential (each merge rewires the neighbor
// graph and updates fluxes before later decisions), so it runs on the
// host.  This translation is operation-for-operation identical to
// ops/detection.py::_merge_segments_py (same edge order, same
// tie-breaking, same double-precision math), so the roots are
// bit-identical (tests/test_torch_segmerge.py).  dvm_lutz is the
// multi-threshold tree of DetectionConfig.deblend_algo='lutz'.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 segmerge.cpp -o libsegmerge.so
// (kernels/segmerge.py does this at first use, into _build/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

int64_t find_root(std::vector<int64_t>& parent, int64_t x) {
    int64_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {  // path compression
        int64_t nxt = parent[x];
        parent[x] = root;
        x = nxt;
    }
    return root;
}

// Quantization level of value v within [thr, island_peak], 64 exponential
// steps (mirrors the Python `level` closure exactly).
int64_t level(double v, double island_peak, double thr, int64_t nthr) {
    if (island_peak <= thr || v <= thr) return 0;
    double x = std::log(v / thr) / std::log(island_peak / thr);
    double q = std::floor(x * (double)nthr);
    if (q < 0.0) q = 0.0;
    if (q > (double)nthr) q = (double)nthr;
    return (int64_t)q;
}

}  // namespace

extern "C" {

// Runs the merge loop.  flux is modified in place (the caller passes a
// copy); roots_out[i] receives the final root compact-id of segment i.
// Returns the number of merges performed.
int64_t dvm_merge(int64_t L, int64_t E,
                  const int64_t* ea, const int64_t* eb, const double* eh,
                  const double* peak, double* flux,
                  const int64_t* order,
                  int64_t nthr, double thr, double cont,
                  int64_t* roots_out) {
    std::vector<int64_t> parent(L);
    for (int64_t i = 0; i < L; ++i) parent[i] = i;

    // incident edge-index lists, same construction order as the Python
    std::vector<std::vector<int64_t>> incident(L);
    for (int64_t e = 0; e < E; ++e) {
        incident[ea[e]].push_back(e);
        incident[eb[e]].push_back(e);
    }

    int64_t n_merges = 0;
    bool changed = true;
    while (changed) {
        changed = false;
        for (int64_t k = 0; k < L; ++k) {
            int64_t r = order[k];
            if (parent[r] != r) continue;
            // best saddle to any touching neighbor (by current roots);
            // strict > keeps the first edge on ties, like the Python
            int64_t best_other = -1;
            double best_h = -INFINITY;
            for (int64_t e : incident[r]) {
                int64_t ra = find_root(parent, ea[e]);
                int64_t rb = find_root(parent, eb[e]);
                if (ra == rb) continue;
                int64_t other = (ra == r) ? rb : ra;
                if (eh[e] > best_h) {
                    best_other = other;
                    best_h = eh[e];
                }
            }
            if (best_other < 0) continue;
            if (peak[best_other] < peak[r]) continue;  // only into brighter
            double island_peak = peak[r] > peak[best_other] ? peak[r] : peak[best_other];
            double island_flux = flux[r] + flux[best_other];
            bool separated =
                level(peak[r], island_peak, thr, nthr) >
                level(best_h, island_peak, thr, nthr);
            bool significant = flux[r] > cont * island_flux;
            if (!(separated && significant)) {
                parent[r] = best_other;
                flux[best_other] += flux[r];
                auto& src = incident[r];
                auto& dst = incident[best_other];
                dst.insert(dst.end(), src.begin(), src.end());
                src.clear();
                src.shrink_to_fit();
                changed = true;
                ++n_merges;
            }
        }
    }

    for (int64_t i = 0; i < L; ++i) roots_out[i] = find_root(parent, i);
    return n_merges;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// sep-faithful multi-threshold deblending tree (opt-in deblend_algo='lutz').
//
// Implements the documented SExtractor deblender (Bertin & Arnouts 1996
// appendix; the algorithm behind the reference's sep.extract
// deblend_nthresh/deblend_cont parameters) from its published description —
// NOT a translation of sep's C:
//
//   1. Each island (8-connected component of above-threshold pixels) gets
//      `nthr` exponentially-spaced sub-thresholds between the detection
//      threshold and its peak.
//   2. The component tree is built level-by-level from the top.  At a
//      junction where k branches meet, a branch is SIGNIFICANT iff its
//      integrated intensity (sum of its pixel values above the junction
//      level) exceeds `cont` x the island's total intensity; if >=2
//      branches at the junction are significant, each becomes (or stays) a
//      separate object; otherwise everything melts together.
//   3. Pixels not belonging to any object branch (below the separating
//      levels) are "gathered up": each is assigned to the object with the
//      highest bivariate-Gaussian membership probability, amplitude = the
//      object's core flux, moments = the core pixels' (clamped) second
//      moments — the SExtractor assignment rule, deterministic argmax.
//
// Inputs are the masked-pixel COO (flat indices, filtered values) plus the
// 8-neighbor pixel edge list; output is one object label per pixel, the
// label being the flat index of the object's peak pixel (the contract the
// COO postprocess expects: a peak carries its own index).

namespace {

struct Snap {        // component snapshot at the previous level boundary
    double flux;
    int64_t npix;
    double peak;
    int64_t peak_pix;   // pixel array-index of the branch peak
    int64_t head, tail; // linked pixel list (append-only; concat on union)
    int64_t n_objs;     // objects already created inside this component
};

}  // namespace

extern "C" {

// N pixels, E edges (array indices into the pixel arrays, 8-neighbor pairs
// among masked pixels).  val: filtered values; flat: global flat indices
// (y*f + x).  Writes labels_out[i] = flat index of pixel i's object peak.
// Returns the number of objects, or -1 on allocation failure.
int64_t dvm_lutz(int64_t N, int64_t E,
                 const double* val, const int64_t* flat,
                 const int64_t* ea, const int64_t* eb,
                 int64_t f, int64_t nthr, double thr, double cont,
                 int64_t* labels_out) {
    if (N == 0) return 0;
    if (nthr < 1) nthr = 1;
    if (thr <= 0) thr = 1e-30;

    // ---- islands (union-find over all pixel edges)
    std::vector<int64_t> parent(N);
    for (int64_t i = 0; i < N; ++i) parent[i] = i;
    for (int64_t e = 0; e < E; ++e) {
        int64_t ra = find_root(parent, ea[e]);
        int64_t rb = find_root(parent, eb[e]);
        if (ra != rb) parent[ra] = rb;
    }
    // island stats + compact ids
    std::vector<int64_t> isl(N);
    std::vector<int64_t> roots;  // island root -> compact id via map below
    std::vector<int64_t> root_id(N, -1);
    int64_t n_isl = 0;
    for (int64_t i = 0; i < N; ++i) {
        int64_t r = find_root(parent, i);
        if (root_id[r] < 0) { root_id[r] = n_isl++; roots.push_back(r); }
        isl[i] = root_id[r];
    }
    std::vector<double> i_flux(n_isl, 0.0), i_peak(n_isl, 0.0);
    for (int64_t i = 0; i < N; ++i) {
        i_flux[isl[i]] += val[i];
        if (val[i] > i_peak[isl[i]]) i_peak[isl[i]] = val[i];
    }

    // quantized level of pixel i within its island (0..nthr; peak = nthr)
    auto qlevel = [&](double v, double peak) -> int64_t {
        if (peak <= thr || v <= thr) return 0;
        double x = std::log(v / thr) / std::log(peak / thr);
        double q = std::floor(x * (double)nthr);
        if (q < 0.0) q = 0.0;
        if (q > (double)nthr) q = (double)nthr;
        return (int64_t)q;
    };
    std::vector<int64_t> lev(N);
    for (int64_t i = 0; i < N; ++i) lev[i] = qlevel(val[i], i_peak[isl[i]]);

    // global processing order: island, then level desc, then value desc,
    // then flat asc (determinism)
    std::vector<int64_t> order(N);
    for (int64_t i = 0; i < N; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        if (isl[a] != isl[b]) return isl[a] < isl[b];
        if (lev[a] != lev[b]) return lev[a] > lev[b];
        if (val[a] != val[b]) return val[a] > val[b];
        return flat[a] < flat[b];
    });

    // per-pixel sorted adjacency (for deterministic neighbor iteration)
    std::vector<int64_t> deg(N + 1, 0);
    for (int64_t e = 0; e < E; ++e) { ++deg[ea[e] + 1]; ++deg[eb[e] + 1]; }
    for (int64_t i = 0; i < N; ++i) deg[i + 1] += deg[i];
    std::vector<int64_t> adj(2 * E);
    {
        std::vector<int64_t> cur(deg.begin(), deg.end() - 1);
        for (int64_t e = 0; e < E; ++e) {
            adj[cur[ea[e]]++] = eb[e];
            adj[cur[eb[e]]++] = ea[e];
        }
        for (int64_t i = 0; i < N; ++i)
            std::sort(adj.begin() + deg[i], adj.begin() + deg[i + 1]);
    }

    // ---- per-island component tree, processed via the global order
    // component state lives on the union-find root
    std::vector<int64_t> cparent(N), next_pix(N, -1);
    std::vector<Snap> comp(N);          // live state, indexed by root
    std::vector<Snap> snap(N);          // previous-level snapshot by phase-A root
    std::vector<int64_t> snap_of(N, -1);   // root -> its phase-A snapshot id (self)
    std::vector<char> active(N, 0);
    std::vector<int64_t> obj_of(N, -1);    // pixel -> object id
    std::vector<int64_t> obj_peak_flat;    // object id -> peak flat index
    // children (phase-A snapshot ids) absorbed by each current root this level
    std::vector<std::vector<int64_t>> kids(N);
    std::vector<int64_t> n_objs_in(N, 0);  // per-root created-object count

    auto cfind = [&](int64_t x) { return find_root(cparent, x); };

    int64_t p0 = 0;
    while (p0 < N) {
        int64_t island = isl[order[p0]];
        int64_t p1 = p0;
        while (p1 < N && isl[order[p1]] == island) ++p1;
        double IFLUX = i_flux[island];

        // process this island level by level (descending)
        int64_t s = p0;
        std::vector<int64_t> touched;  // roots that absorbed children this level
        while (s < p1) {
            int64_t L = lev[order[s]];
            int64_t t = s;
            while (t < p1 && lev[order[t]] == L) ++t;

            // phase A: snapshot every active component of this island (the
            // state at threshold t_{L+1}); roots are their own snapshot id.
            // Refresh EVERY level — a surviving component's snapshot must
            // include the pixels it gained at higher levels.
            for (int64_t k = p0; k < s; ++k) {
                int64_t r = cfind(order[k]);
                if (snap_of[r] != r || snap[r].npix != comp[r].npix) {
                    snap[r] = comp[r];
                }
                snap_of[r] = r;
            }

            // phase B: add level-L pixels, union with active neighbors
            touched.clear();
            for (int64_t k = s; k < t; ++k) {
                int64_t p = order[k];
                cparent[p] = p;
                comp[p] = Snap{val[p], 1, val[p], p, p, p, 0};
                next_pix[p] = -1;
                active[p] = 1;
                snap_of[p] = -2;  // born this level: not a phase-A child
                n_objs_in[p] = 0;
                for (int64_t a = deg[p]; a < deg[p + 1]; ++a) {
                    int64_t q = adj[a];
                    if (!active[q]) continue;
                    int64_t rp = cfind(p), rq = cfind(q);
                    if (rp == rq) continue;
                    // merge rq INTO rp's current root keeping rp's identity
                    // bookkeeping stable; collect phase-A children
                    cparent[rq] = rp;
                    // concat pixel lists (rp keeps its prefix)
                    next_pix[comp[rp].tail] = comp[rq].head;
                    comp[rp].tail = comp[rq].tail;
                    comp[rp].flux += comp[rq].flux;
                    comp[rp].npix += comp[rq].npix;
                    if (comp[rq].peak > comp[rp].peak ||
                        (comp[rq].peak == comp[rp].peak &&
                         flat[comp[rq].peak_pix] < flat[comp[rp].peak_pix])) {
                        comp[rp].peak = comp[rq].peak;
                        comp[rp].peak_pix = comp[rq].peak_pix;
                    }
                    comp[rp].n_objs += comp[rq].n_objs;
                    // child bookkeeping
                    if (kids[rp].empty() && kids[rq].empty() &&
                        snap_of[rp] != rp && snap_of[rq] != rq) {
                        // neither side carries phase-A components: plain merge
                    } else {
                        if (kids[rp].empty() && snap_of[rp] == rp)
                            kids[rp].push_back(rp);
                        if (snap_of[rq] == rq) kids[rp].push_back(rq);
                        for (int64_t c : kids[rq]) kids[rp].push_back(c);
                        kids[rq].clear();
                        if (kids[rp].size() > 0) touched.push_back(rp);
                    }
                }
            }

            // phase C: junctions — roots that absorbed >=2 phase-A
            // children this level.  kids lists are per-level: clear them
            // all afterwards (a 1-child absorb is growth, not a junction).
            for (int64_t r : touched) {
                if (cfind(r) != r) continue;  // kids moved to the new root
                if (kids[r].empty()) continue;  // already handled (dupes)
                // dedupe children (a root can appear via several edges)
                std::sort(kids[r].begin(), kids[r].end());
                kids[r].erase(std::unique(kids[r].begin(), kids[r].end()),
                              kids[r].end());
                if (kids[r].size() >= 2) {
                    int64_t n_sig = 0;
                    for (int64_t c : kids[r])
                        if (snap[c].flux > cont * IFLUX) ++n_sig;
                    if (n_sig >= 2) {
                        for (int64_t c : kids[r]) {
                            if (snap[c].flux <= cont * IFLUX) continue;
                            if (snap[c].n_objs > 0) continue;  // already split
                            int64_t oid = (int64_t)obj_peak_flat.size();
                            obj_peak_flat.push_back(flat[snap[c].peak_pix]);
                            // assign the branch's snapshot pixels
                            int64_t px = snap[c].head;
                            for (int64_t n = 0; n < snap[c].npix; ++n) {
                                if (obj_of[px] < 0) obj_of[px] = oid;
                                px = next_pix[px];
                            }
                            ++comp[r].n_objs;
                        }
                    }
                }
                kids[r].clear();
            }
            s = t;
        }

        // island finished: the final root
        int64_t R = cfind(order[p0]);
        if (comp[R].n_objs == 0) {
            // never split: one object = the whole island
            int64_t oid = (int64_t)obj_peak_flat.size();
            obj_peak_flat.push_back(flat[comp[R].peak_pix]);
            for (int64_t k = p0; k < p1; ++k) obj_of[order[k]] = oid;
        } else {
            // gatherup: bivariate-Gaussian argmax for unassigned pixels
            // collect this island's object ids + core moments
            std::vector<int64_t> oids;
            for (int64_t k = p0; k < p1; ++k) {
                int64_t o = obj_of[order[k]];
                if (o >= 0 && (oids.empty() || oids.back() != o))
                    oids.push_back(o);
            }
            std::sort(oids.begin(), oids.end());
            oids.erase(std::unique(oids.begin(), oids.end()), oids.end());
            int64_t K = (int64_t)oids.size();
            std::vector<double> A(K, 0), my(K, 0), mx(K, 0), cyy(K, 0),
                cxx(K, 0), cxy(K, 0);
            std::vector<int64_t> oix(obj_peak_flat.size(), -1);
            for (int64_t j = 0; j < K; ++j) oix[oids[j]] = j;
            for (int64_t k = p0; k < p1; ++k) {
                int64_t i = order[k], o = obj_of[i];
                if (o < 0) continue;
                int64_t j = oix[o];
                double w = val[i] > 0 ? val[i] : 0.0;
                A[j] += w;
                my[j] += w * (double)(flat[i] / f);
                mx[j] += w * (double)(flat[i] % f);
            }
            for (int64_t j = 0; j < K; ++j) {
                double a = A[j] > 1e-30 ? A[j] : 1e-30;
                my[j] /= a; mx[j] /= a;
            }
            for (int64_t k = p0; k < p1; ++k) {
                int64_t i = order[k], o = obj_of[i];
                if (o < 0) continue;
                int64_t j = oix[o];
                double w = val[i] > 0 ? val[i] : 0.0;
                double dy = (double)(flat[i] / f) - my[j];
                double dx = (double)(flat[i] % f) - mx[j];
                cyy[j] += w * dy * dy; cxx[j] += w * dx * dx;
                cxy[j] += w * dy * dx;
            }
            for (int64_t j = 0; j < K; ++j) {
                double a = A[j] > 1e-30 ? A[j] : 1e-30;
                // pixelization floor (SExtractor clamps degenerate moments)
                cyy[j] = cyy[j] / a + 1.0 / 12.0;
                cxx[j] = cxx[j] / a + 1.0 / 12.0;
                cxy[j] /= a;
                double det = cyy[j] * cxx[j] - cxy[j] * cxy[j];
                if (det < 1e-12) {  // collinear cores: relax covariance
                    cxy[j] = 0.0;
                    det = cyy[j] * cxx[j];
                }
            }
            for (int64_t k = p0; k < p1; ++k) {
                int64_t i = order[k];
                if (obj_of[i] >= 0) continue;
                double y = (double)(flat[i] / f), x = (double)(flat[i] % f);
                double best = -INFINITY;
                int64_t bj = 0;
                for (int64_t j = 0; j < K; ++j) {
                    double det = cyy[j] * cxx[j] - cxy[j] * cxy[j];
                    double dy = y - my[j], dx = x - mx[j];
                    double m = (cxx[j] * dy * dy - 2 * cxy[j] * dy * dx +
                                cyy[j] * dx * dx) / det;
                    double lp = std::log(A[j]) - 0.5 * std::log(det) - 0.5 * m;
                    if (lp > best) { best = lp; bj = j; }
                }
                obj_of[i] = oids[bj];
            }
        }
        p0 = p1;
    }

    for (int64_t i = 0; i < N; ++i) labels_out[i] = obj_peak_flat[obj_of[i]];
    return (int64_t)obj_peak_flat.size();
}

}  // extern "C"
