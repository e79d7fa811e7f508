// mapstore.cpp — native scene-map / observation-graph runtime.
//
// C++ replacement for the reference's pointer-graph model layer
// (ba_project/src/model/{Frame,MapPoint,SceneMap}.{h,cpp}): keyframe records,
// landmark records, the observation graph, covisibility weights, landmark /
// keyframe culling, and fused-landmark lifecycle.  Where the reference keeps
// std::shared_ptr webs guarded by per-object mutexes, this store is a single
// arena of fixed-capacity SoA arrays + index lists, designed so the Python
// layer can snapshot flat observation tables (cam_idx / pt_idx / uv / sigma2)
// straight into device buffers for the solvers — the branchy graph
// mutation stays native, the math stays on the device.
//
// Copied from bundleadjustment_tpu/native/mapstore.cpp so that the
// PyTorch port runs where the JAX package is absent.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct Obs {
  int32_t kf;
  int32_t kp;
};

struct MapStore {
  // capacities
  int32_t max_kf, max_pt, max_kp, desc_words;

  // keyframe SoA
  std::vector<uint8_t> kf_active;
  std::vector<uint8_t> kf_is_keyframe;
  std::vector<double> kf_timestamp;
  std::vector<double> kf_pose;   // [max_kf * 6] world->camera rt6
  std::vector<double> kf_gt;     // [max_kf * 16] GT pose 4x4 (cam->world), row major
  std::vector<int32_t> kf_nkp;   // keypoints used
  std::vector<float> kp_xy;      // [max_kf * max_kp * 2]
  std::vector<int32_t> kp_octave;
  std::vector<float> kp_sigma2;
  std::vector<uint32_t> kp_desc;  // [max_kf * max_kp * desc_words]
  std::vector<int32_t> kp_pt;     // point index or -1
  std::vector<uint8_t> kp_outlier;

  // landmark SoA
  std::vector<uint8_t> pt_active;
  std::vector<float> pt_pos;  // [max_pt * 3]
  std::vector<uint32_t> pt_desc;
  std::vector<int32_t> pt_first_kf;  // keyframe id at creation (culling window)
  std::vector<std::vector<Obs>> pt_obs;

  // covisibility cache: per keyframe, sorted (weight desc) neighbor list
  std::vector<std::vector<std::pair<int32_t, int32_t>>> covis;  // (kf, weight)

  int32_t n_kf_slots = 0;  // high-water mark
  int32_t n_pt_slots = 0;

  size_t kp_base(int32_t kf) const { return (size_t)kf * max_kp; }
};

inline bool kp_ok(const MapStore* m, int32_t kf, int32_t kp) {
  return kf >= 0 && kf < m->n_kf_slots && m->kf_active[kf] && kp >= 0 &&
         kp < m->kf_nkp[kf];
}

// axis-angle -> row-major rotation matrix (Rodrigues)
inline void aa_to_rot(const double* r, double R[9]) {
  double th = std::sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]);
  if (th < 1e-12) {
    R[0] = R[4] = R[8] = 1.0;
    R[1] = R[2] = R[3] = R[5] = R[6] = R[7] = 0.0;
    return;
  }
  double kx = r[0] / th, ky = r[1] / th, kz = r[2] / th;
  double c = std::cos(th), s = std::sin(th), v = 1.0 - c;
  R[0] = c + kx * kx * v;
  R[1] = kx * ky * v - kz * s;
  R[2] = kx * kz * v + ky * s;
  R[3] = ky * kx * v + kz * s;
  R[4] = c + ky * ky * v;
  R[5] = ky * kz * v - kx * s;
  R[6] = kz * kx * v - ky * s;
  R[7] = kz * ky * v + kx * s;
  R[8] = c + kz * kz * v;
}

// camera center of a world->camera rt6 pose: C = -R^T t
inline void kf_center(const MapStore* m, int32_t kf, double C[3]) {
  const double* p = &m->kf_pose[(size_t)kf * 6];
  double R[9];
  aa_to_rot(p, R);
  const double* t = p + 3;
  C[0] = -(R[0] * t[0] + R[3] * t[1] + R[6] * t[2]);
  C[1] = -(R[1] * t[0] + R[4] * t[1] + R[7] * t[2]);
  C[2] = -(R[2] * t[0] + R[5] * t[1] + R[8] * t[2]);
}

inline int hamming(const uint32_t* a, const uint32_t* b, int words) {
  int d = 0;
  for (int w = 0; w < words; ++w) d += __builtin_popcount(a[w] ^ b[w]);
  return d;
}

// Representative descriptor = the observation descriptor with minimum median
// Hamming distance to the others (reference MapPoint::computeDescriptor,
// src/model/MapPoint.cpp:202-252, with Hamming replacing SURF L2).
inline void refresh_descriptor(MapStore* m, int32_t pt) {
  if (pt < 0 || pt >= m->n_pt_slots || !m->pt_active[pt]) return;
  std::vector<const uint32_t*> descs;
  descs.reserve(m->pt_obs[pt].size());
  for (auto& o : m->pt_obs[pt]) {
    if (!m->kf_active[o.kf]) continue;
    descs.push_back(&m->kp_desc[(m->kp_base(o.kf) + o.kp) * m->desc_words]);
  }
  int k = (int)descs.size();
  if (k == 0) return;
  if (k == 1) {
    std::memcpy(&m->pt_desc[(size_t)pt * m->desc_words], descs[0],
                m->desc_words * sizeof(uint32_t));
    return;
  }
  int best = 0, best_med = INT32_MAX;
  std::vector<int> row(k);
  for (int i = 0; i < k; ++i) {
    for (int j = 0; j < k; ++j)
      row[j] = hamming(descs[i], descs[j], m->desc_words);
    std::nth_element(row.begin(), row.begin() + k / 2, row.end());
    int med = row[k / 2];
    if (med < best_med) { best_med = med; best = i; }
  }
  std::memcpy(&m->pt_desc[(size_t)pt * m->desc_words], descs[best],
              m->desc_words * sizeof(uint32_t));
}

}  // namespace

extern "C" {

MapStore* map_create(int32_t max_kf, int32_t max_pt, int32_t max_kp,
                     int32_t desc_words) {
  auto* m = new MapStore();
  m->max_kf = max_kf;
  m->max_pt = max_pt;
  m->max_kp = max_kp;
  m->desc_words = desc_words;
  m->kf_active.assign(max_kf, 0);
  m->kf_is_keyframe.assign(max_kf, 0);
  m->kf_timestamp.assign(max_kf, 0.0);
  m->kf_pose.assign((size_t)max_kf * 6, 0.0);
  m->kf_gt.assign((size_t)max_kf * 16, 0.0);
  m->kf_nkp.assign(max_kf, 0);
  m->kp_xy.assign((size_t)max_kf * max_kp * 2, 0.f);
  m->kp_octave.assign((size_t)max_kf * max_kp, 0);
  m->kp_sigma2.assign((size_t)max_kf * max_kp, 1.f);
  m->kp_desc.assign((size_t)max_kf * max_kp * desc_words, 0u);
  m->kp_pt.assign((size_t)max_kf * max_kp, -1);
  m->kp_outlier.assign((size_t)max_kf * max_kp, 0);
  m->pt_active.assign(max_pt, 0);
  m->pt_pos.assign((size_t)max_pt * 3, 0.f);
  m->pt_desc.assign((size_t)max_pt * desc_words, 0u);
  m->pt_first_kf.assign(max_pt, -1);
  m->pt_obs.resize(max_pt);
  m->covis.resize(max_kf);
  return m;
}

void map_destroy(MapStore* m) { delete m; }

// ---------------------------------------------------------------------------
// keyframes
// ---------------------------------------------------------------------------

int32_t map_add_frame(MapStore* m, double timestamp, const double* pose6,
                      const double* gt16, int32_t n_kp, const float* xy,
                      const int32_t* octave, const float* sigma2,
                      const uint32_t* desc) {
  if (m->n_kf_slots >= m->max_kf) return -1;
  int32_t kf = m->n_kf_slots++;
  m->kf_active[kf] = 1;
  m->kf_is_keyframe[kf] = 0;
  m->kf_timestamp[kf] = timestamp;
  std::memcpy(&m->kf_pose[(size_t)kf * 6], pose6, 6 * sizeof(double));
  if (gt16) std::memcpy(&m->kf_gt[(size_t)kf * 16], gt16, 16 * sizeof(double));
  n_kp = std::min(n_kp, m->max_kp);
  m->kf_nkp[kf] = n_kp;
  size_t b = m->kp_base(kf);
  std::memcpy(&m->kp_xy[b * 2], xy, (size_t)n_kp * 2 * sizeof(float));
  std::memcpy(&m->kp_octave[b], octave, (size_t)n_kp * sizeof(int32_t));
  std::memcpy(&m->kp_sigma2[b], sigma2, (size_t)n_kp * sizeof(float));
  std::memcpy(&m->kp_desc[b * m->desc_words], desc,
              (size_t)n_kp * m->desc_words * sizeof(uint32_t));
  std::fill(m->kp_pt.begin() + b, m->kp_pt.begin() + b + n_kp, -1);
  std::fill(m->kp_outlier.begin() + b, m->kp_outlier.begin() + b + n_kp, 0);
  return kf;
}

void map_set_keyframe(MapStore* m, int32_t kf, int32_t flag) {
  if (kf >= 0 && kf < m->n_kf_slots) m->kf_is_keyframe[kf] = (uint8_t)flag;
}

void map_set_pose(MapStore* m, int32_t kf, const double* pose6) {
  if (kf >= 0 && kf < m->n_kf_slots)
    std::memcpy(&m->kf_pose[(size_t)kf * 6], pose6, 6 * sizeof(double));
}

void map_get_pose(const MapStore* m, int32_t kf, double* out6) {
  std::memcpy(out6, &m->kf_pose[(size_t)kf * 6], 6 * sizeof(double));
}

// Erase a (non-key)frame entirely: detach all its observations.
// Reference Frame::erase, src/model/Frame.cpp:419-440.
void map_erase_frame(MapStore* m, int32_t kf) {
  if (kf < 0 || kf >= m->n_kf_slots || !m->kf_active[kf]) return;
  size_t b = m->kp_base(kf);
  for (int32_t kp = 0; kp < m->kf_nkp[kf]; ++kp) {
    int32_t pt = m->kp_pt[b + kp];
    if (pt >= 0 && m->pt_active[pt]) {
      auto& obs = m->pt_obs[pt];
      obs.erase(std::remove_if(obs.begin(), obs.end(),
                               [kf](const Obs& o) { return o.kf == kf; }),
                obs.end());
    }
  }
  m->kf_active[kf] = 0;
  m->kf_is_keyframe[kf] = 0;
  m->covis[kf].clear();
}

// ---------------------------------------------------------------------------
// landmarks + observations
// ---------------------------------------------------------------------------

int32_t map_add_point(MapStore* m, const float* pos3, const uint32_t* desc,
                      int32_t first_kf) {
  if (m->n_pt_slots >= m->max_pt) return -1;
  int32_t pt = m->n_pt_slots++;
  m->pt_active[pt] = 1;
  std::memcpy(&m->pt_pos[(size_t)pt * 3], pos3, 3 * sizeof(float));
  if (desc)
    std::memcpy(&m->pt_desc[(size_t)pt * m->desc_words], desc,
                m->desc_words * sizeof(uint32_t));
  m->pt_first_kf[pt] = first_kf;
  m->pt_obs[pt].clear();
  return pt;
}

void map_set_point_pos(MapStore* m, int32_t pt, const float* pos3) {
  if (pt >= 0 && pt < m->n_pt_slots && m->pt_active[pt])
    std::memcpy(&m->pt_pos[(size_t)pt * 3], pos3, 3 * sizeof(float));
}

// Attach: point <-> (kf, kp).  Reference MapPoint::addObservation
// (src/model/MapPoint.cpp:51-61) + Frame keypoint->mappoint array.
int32_t map_add_observation(MapStore* m, int32_t pt, int32_t kf, int32_t kp) {
  if (pt < 0 || pt >= m->n_pt_slots || !m->pt_active[pt]) return -1;
  if (!kp_ok(m, kf, kp)) return -1;
  size_t b = m->kp_base(kf);
  if (m->kp_pt[b + kp] == pt) return 0;
  if (m->kp_pt[b + kp] >= 0) return -2;  // slot taken; caller decides fuse
  // one observation per frame per landmark (the reference's obs map is
  // keyed by Frame, src/model/MapPoint.cpp:51-61): without this, cross-
  // neighbor transfers matching different keypoints of one frame to the
  // same landmark double-count constraints (and blew max-obs-per-landmark
  // past 256 in 48-keyframe maps)
  for (auto& o : m->pt_obs[pt])
    if (o.kf == kf) return -3;
  m->kp_pt[b + kp] = pt;
  m->kp_outlier[b + kp] = 0;
  m->pt_obs[pt].push_back({kf, kp});
  return 1;
}

void map_remove_observation(MapStore* m, int32_t pt, int32_t kf) {
  if (pt < 0 || pt >= m->n_pt_slots) return;
  auto& obs = m->pt_obs[pt];
  for (auto& o : obs)
    if (o.kf == kf) m->kp_pt[m->kp_base(kf) + o.kp] = -1;
  obs.erase(std::remove_if(obs.begin(), obs.end(),
                           [kf](const Obs& o) { return o.kf == kf; }),
            obs.end());
}

// Erase a landmark: detach everywhere.  Reference MapPoint::erase
// (src/model/MapPoint.cpp:295-310).
void map_erase_point(MapStore* m, int32_t pt) {
  if (pt < 0 || pt >= m->n_pt_slots || !m->pt_active[pt]) return;
  for (auto& o : m->pt_obs[pt]) {
    size_t b = m->kp_base(o.kf);
    if (m->kp_pt[b + o.kp] == pt) m->kp_pt[b + o.kp] = -1;
  }
  m->pt_obs[pt].clear();
  m->pt_active[pt] = 0;
}

// Merge `merge` into `keep`: transfer observations (skip keyframes where keep
// already observed), then erase `merge`.  Reference MapPoint::fuse
// (src/model/MapPoint.cpp:130-164).
void map_fuse_points(MapStore* m, int32_t keep, int32_t merge) {
  if (keep == merge || keep < 0 || merge < 0) return;
  if (!m->pt_active[keep] || !m->pt_active[merge]) return;
  for (auto& o : m->pt_obs[merge]) {
    bool seen = false;
    for (auto& k : m->pt_obs[keep])
      if (k.kf == o.kf) { seen = true; break; }
    size_t b = m->kp_base(o.kf);
    if (seen) {
      if (m->kp_pt[b + o.kp] == merge) m->kp_pt[b + o.kp] = -1;
    } else {
      m->kp_pt[b + o.kp] = keep;
      m->pt_obs[keep].push_back(o);
    }
  }
  m->pt_obs[merge].clear();
  m->pt_active[merge] = 0;
}

void map_set_outlier(MapStore* m, int32_t kf, int32_t kp, int32_t flag) {
  if (kp_ok(m, kf, kp)) m->kp_outlier[m->kp_base(kf) + kp] = (uint8_t)flag;
}

int32_t map_point_obs_count(const MapStore* m, int32_t pt) {
  if (pt < 0 || pt >= m->n_pt_slots || !m->pt_active[pt]) return 0;
  return (int32_t)m->pt_obs[pt].size();
}

// batched variant: one FFI crossing for a whole id array (the per-frame
// fused-tracking capture queries every keypoint's landmark)
void map_point_obs_counts(const MapStore* m, const int32_t* ids, int32_t n,
                          int32_t* out) {
  for (int32_t i = 0; i < n; ++i) out[i] = map_point_obs_count(m, ids[i]);
}

// ---------------------------------------------------------------------------
// covisibility — reference Frame::updateCovisibilityGraph
// (src/model/Frame.cpp:292-374): count shared landmarks, keep edges with
// weight >= threshold (10), always keep the max-weight neighbor.
// ---------------------------------------------------------------------------

void map_update_covisibility(MapStore* m, int32_t kf, int32_t threshold) {
  if (kf < 0 || kf >= m->n_kf_slots || !m->kf_active[kf]) return;
  std::unordered_map<int32_t, int32_t> counter;
  size_t b = m->kp_base(kf);
  for (int32_t kp = 0; kp < m->kf_nkp[kf]; ++kp) {
    int32_t pt = m->kp_pt[b + kp];
    if (pt < 0 || !m->pt_active[pt] || m->kp_outlier[b + kp]) continue;
    for (auto& o : m->pt_obs[pt]) {
      if (o.kf == kf || !m->kf_active[o.kf] || !m->kf_is_keyframe[o.kf])
        continue;
      counter[o.kf]++;
    }
  }
  auto& edges = m->covis[kf];
  edges.clear();
  int32_t best_kf = -1, best_w = 0;
  for (auto& kv : counter) {
    if (kv.second > best_w) { best_w = kv.second; best_kf = kv.first; }
    if (kv.second >= threshold) edges.push_back({kv.first, kv.second});
  }
  bool has_best = false;
  for (auto& e : edges)
    if (e.first == best_kf) { has_best = true; break; }
  if (!has_best && best_kf >= 0) edges.push_back({best_kf, best_w});
  std::sort(edges.begin(), edges.end(),
            [](auto& a, auto& b2) { return a.second > b2.second; });
}

// Fill out_kf[0..n) with the best-covisible keyframes; returns count.
// Reference Frame::getBestCovisibilityFrames (src/model/Frame.cpp:376-386).
int32_t map_best_covisible(const MapStore* m, int32_t kf, int32_t n,
                           int32_t* out_kf, int32_t* out_w) {
  if (kf < 0 || kf >= m->n_kf_slots) return 0;
  int32_t cnt = 0;
  for (auto& e : m->covis[kf]) {
    if (cnt >= n) break;
    if (!m->kf_active[e.first] || !m->kf_is_keyframe[e.first]) continue;
    out_kf[cnt] = e.first;
    if (out_w) out_w[cnt] = e.second;
    ++cnt;
  }
  return cnt;
}

// ---------------------------------------------------------------------------
// culling
// ---------------------------------------------------------------------------

// Landmarks seen by < min_obs keyframes within `window` keyframes of their
// creation are erased.  Reference SfMHelper::cullRecentMapPoints
// (src/ba/SfMHelper.cpp:974-1003).  Returns number erased; erased ids go to
// out (capacity cap).
int32_t map_cull_recent_points(MapStore* m, int32_t current_kf, int32_t window,
                               int32_t min_obs, int32_t* out, int32_t cap) {
  int32_t n = 0;
  for (int32_t pt = 0; pt < m->n_pt_slots; ++pt) {
    if (!m->pt_active[pt]) continue;
    int32_t born = m->pt_first_kf[pt];
    if (born < 0) continue;
    int32_t age = current_kf - born;
    if (age >= 1 && age <= window &&
        (int32_t)m->pt_obs[pt].size() < min_obs) {
      if (n < cap) out[n] = pt;
      ++n;
      map_erase_point(m, pt);
    }
  }
  return n;
}

// Keyframes where >= `redundant_frac` of tracked landmarks are observed by at
// least `min_other` other keyframes at the same-or-finer octave are erased.
// Reference SfMHelper::cullRedundantKeyframes (src/ba/SfMHelper.cpp:1005-1077).
int32_t map_cull_redundant_keyframes(MapStore* m, double redundant_frac,
                                     int32_t min_other, int32_t keep_first,
                                     int32_t* out, int32_t cap) {
  int32_t n = 0;
  for (int32_t kf = keep_first; kf < m->n_kf_slots; ++kf) {
    if (!m->kf_active[kf] || !m->kf_is_keyframe[kf]) continue;
    size_t b = m->kp_base(kf);
    int32_t tracked = 0, redundant = 0;
    for (int32_t kp = 0; kp < m->kf_nkp[kf]; ++kp) {
      int32_t pt = m->kp_pt[b + kp];
      if (pt < 0 || !m->pt_active[pt] || m->kp_outlier[b + kp]) continue;
      ++tracked;
      int32_t oct = m->kp_octave[b + kp];
      int32_t others = 0;
      for (auto& o : m->pt_obs[pt]) {
        if (o.kf == kf || !m->kf_active[o.kf]) continue;
        int32_t o_oct = m->kp_octave[m->kp_base(o.kf) + o.kp];
        if (o_oct <= oct + 1) ++others;
      }
      if (others >= min_other) ++redundant;
    }
    if (tracked > 0 && redundant >= redundant_frac * tracked) {
      if (n < cap) out[n] = kf;
      ++n;
      map_erase_frame(m, kf);
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// snapshot exports (flat observation tables for the solvers)
// ---------------------------------------------------------------------------

int32_t map_num_frames(const MapStore* m) { return m->n_kf_slots; }
int32_t map_num_points(const MapStore* m) { return m->n_pt_slots; }

int32_t map_count_active_keyframes(const MapStore* m) {
  int32_t n = 0;
  for (int32_t kf = 0; kf < m->n_kf_slots; ++kf)
    if (m->kf_active[kf] && m->kf_is_keyframe[kf]) ++n;
  return n;
}

int32_t map_active_keyframes(const MapStore* m, int32_t* out, int32_t cap) {
  int32_t n = 0;
  for (int32_t kf = 0; kf < m->n_kf_slots && n < cap; ++kf)
    if (m->kf_active[kf] && m->kf_is_keyframe[kf]) out[n++] = kf;
  return n;
}

int32_t map_count_active_points(const MapStore* m) {
  int32_t n = 0;
  for (int32_t pt = 0; pt < m->n_pt_slots; ++pt)
    if (m->pt_active[pt]) ++n;
  return n;
}

int32_t map_active_points(const MapStore* m, int32_t* out, int32_t cap) {
  int32_t n = 0;
  for (int32_t pt = 0; pt < m->n_pt_slots && n < cap; ++pt)
    if (m->pt_active[pt]) out[n++] = pt;
  return n;
}

// Export the full observation table over the given keyframe set.
// kf_sel: [n_kf] keyframe slots.  Buffers sized by caller (cap rows).
// Emits rows (kf_order_index, pt, u, v, sigma2) for every non-outlier
// observation whose point is active.  Returns row count (may exceed cap —
// caller re-allocates and retries).
int32_t map_export_observations(const MapStore* m, const int32_t* kf_sel,
                                int32_t n_kf, int32_t include_outliers,
                                int32_t* cam_out, int32_t* pt_out,
                                float* uv_out, float* sig_out,
                                int32_t* kp_out, int32_t cap) {
  int32_t n = 0;
  for (int32_t i = 0; i < n_kf; ++i) {
    int32_t kf = kf_sel[i];
    if (kf < 0 || kf >= m->n_kf_slots || !m->kf_active[kf]) continue;
    size_t b = m->kp_base(kf);
    for (int32_t kp = 0; kp < m->kf_nkp[kf]; ++kp) {
      int32_t pt = m->kp_pt[b + kp];
      if (pt < 0 || !m->pt_active[pt]) continue;
      if (!include_outliers && m->kp_outlier[b + kp]) continue;
      if (n < cap) {
        cam_out[n] = i;
        pt_out[n] = pt;
        uv_out[2 * n] = m->kp_xy[(b + kp) * 2];
        uv_out[2 * n + 1] = m->kp_xy[(b + kp) * 2 + 1];
        sig_out[n] = m->kp_sigma2[b + kp];
        if (kp_out) kp_out[n] = (int32_t)kp;
      }
      ++n;
    }
  }
  return n;
}

// Raw array accessors (zero-copy views for numpy)
float* map_pt_pos_ptr(MapStore* m) { return m->pt_pos.data(); }
uint8_t* map_pt_active_ptr(MapStore* m) { return m->pt_active.data(); }
double* map_kf_pose_ptr(MapStore* m) { return m->kf_pose.data(); }
double* map_kf_gt_ptr(MapStore* m) { return m->kf_gt.data(); }
uint8_t* map_kf_active_ptr(MapStore* m) { return m->kf_active.data(); }
uint8_t* map_kf_is_keyframe_ptr(MapStore* m) { return m->kf_is_keyframe.data(); }
double* map_kf_timestamp_ptr(MapStore* m) { return m->kf_timestamp.data(); }
int32_t* map_kp_pt_ptr(MapStore* m) { return m->kp_pt.data(); }
uint8_t* map_kp_outlier_ptr(MapStore* m) { return m->kp_outlier.data(); }
float* map_kp_xy_ptr(MapStore* m) { return m->kp_xy.data(); }
float* map_kp_sigma2_ptr(MapStore* m) { return m->kp_sigma2.data(); }
int32_t* map_kp_octave_ptr(MapStore* m) { return m->kp_octave.data(); }
uint32_t* map_kp_desc_ptr(MapStore* m) { return m->kp_desc.data(); }
uint32_t* map_pt_desc_ptr(MapStore* m) { return m->pt_desc.data(); }
int32_t* map_kf_nkp_ptr(MapStore* m) { return m->kf_nkp.data(); }
int32_t* map_pt_first_kf_ptr(MapStore* m) { return m->pt_first_kf.data(); }

// Collect the distinct landmarks tracked by a keyframe set and the distinct
// OTHER keyframes observing any of them — the local-BA window closure
// (reference Optimizer.cpp:500-546) in one native pass instead of per-point
// Python round trips.  Returns observer count; pt_out gets the tracked
// landmark ids (count via pt_count).
int32_t map_window_closure(const MapStore* m, const int32_t* kf_sel,
                           int32_t n_kf, int32_t* obs_kf_out, int32_t obs_cap,
                           int32_t* pt_out, int32_t pt_cap,
                           int32_t* pt_count) {
  std::vector<uint8_t> in_window(m->n_kf_slots, 0);
  for (int32_t i = 0; i < n_kf; ++i) {
    int32_t kf = kf_sel[i];
    if (kf >= 0 && kf < m->n_kf_slots) in_window[kf] = 1;
  }
  std::vector<uint8_t> pt_seen(m->n_pt_slots, 0);
  std::vector<uint8_t> obs_seen(m->n_kf_slots, 0);
  int32_t n_pts = 0, n_obs = 0;
  for (int32_t i = 0; i < n_kf; ++i) {
    int32_t kf = kf_sel[i];
    if (kf < 0 || kf >= m->n_kf_slots || !m->kf_active[kf]) continue;
    size_t b = m->kp_base(kf);
    for (int32_t kp = 0; kp < m->kf_nkp[kf]; ++kp) {
      int32_t pt = m->kp_pt[b + kp];
      if (pt < 0 || !m->pt_active[pt] || pt_seen[pt]) continue;
      pt_seen[pt] = 1;
      if (n_pts < pt_cap) pt_out[n_pts] = pt;
      ++n_pts;
      for (auto& o : m->pt_obs[pt]) {
        if (in_window[o.kf] || obs_seen[o.kf]) continue;
        if (!m->kf_active[o.kf] || !m->kf_is_keyframe[o.kf]) continue;
        obs_seen[o.kf] = 1;
        if (n_obs < obs_cap) obs_kf_out[n_obs] = o.kf;
        ++n_obs;
      }
    }
  }
  if (pt_count) *pt_count = n_pts;
  return n_obs;
}

// Batched mean viewing directions (reference
// MapPoint::computeViewingDirection, src/model/MapPoint.cpp:166-200): the
// normalized mean of unit vectors from each observing keyframe's camera
// center to the landmark.  out3 is [n * 3] doubles; points with no live
// observations get the zero vector.  Replaces the former per-point Python
// loop on the keyframe transfer-gate path.
void map_point_view_dirs(const MapStore* m, const int32_t* ids, int32_t n,
                         double* out3) {
  // camera centers once per call (cheap: <= n_kf_slots Rodrigues evals)
  std::vector<double> centers((size_t)m->n_kf_slots * 3, 0.0);
  std::vector<uint8_t> have(m->n_kf_slots, 0);
  for (int32_t i = 0; i < n; ++i) {
    double* out = out3 + (size_t)i * 3;
    out[0] = out[1] = out[2] = 0.0;
    int32_t pt = ids[i];
    if (pt < 0 || pt >= m->n_pt_slots || !m->pt_active[pt]) continue;
    const float* X = &m->pt_pos[(size_t)pt * 3];
    double acc[3] = {0, 0, 0};
    for (auto& o : m->pt_obs[pt]) {
      if (!m->kf_active[o.kf]) continue;
      if (!have[o.kf]) {
        kf_center(m, o.kf, &centers[(size_t)o.kf * 3]);
        have[o.kf] = 1;
      }
      const double* C = &centers[(size_t)o.kf * 3];
      double v[3] = {X[0] - C[0], X[1] - C[1], X[2] - C[2]};
      double nn = std::sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
      if (nn > 1e-12) {
        acc[0] += v[0] / nn;
        acc[1] += v[1] / nn;
        acc[2] += v[2] / nn;
      }
    }
    double nn = std::sqrt(acc[0] * acc[0] + acc[1] * acc[1] + acc[2] * acc[2]);
    if (nn > 1e-12) {
      out[0] = acc[0] / nn;
      out[1] = acc[1] / nn;
      out[2] = acc[2] / nn;
    }
  }
}

// Batched representative-descriptor refresh over explicit landmark ids.
void map_refresh_point_descriptors(MapStore* m, const int32_t* ids,
                                   int32_t n) {
  for (int32_t i = 0; i < n; ++i) refresh_descriptor(m, ids[i]);
}

// out[i] = 1 iff any observation of ids[i] is flagged outlier — the
// reference viewer's inlier/outlier landmark partition
// (src/visualization/Visualizer.cpp:79-89).
void map_point_has_outlier_obs(const MapStore* m, const int32_t* ids,
                               int32_t n, uint8_t* out) {
  for (int32_t i = 0; i < n; ++i) {
    out[i] = 0;
    int32_t pt = ids[i];
    if (pt < 0 || pt >= m->n_pt_slots || !m->pt_active[pt]) continue;
    for (auto& o : m->pt_obs[pt]) {
      if (!m->kf_active[o.kf]) continue;
      if (m->kp_outlier[m->kp_base(o.kf) + o.kp]) { out[i] = 1; break; }
    }
  }
}

// Refresh every landmark observed (non-outlier) by frame `kf` — the batched
// equivalent of the reference refreshing on each addObservation/fuse
// (MapPoint.cpp:51-61,130-164): after a frame's observation writes, one pass
// over its tracked landmarks restores the same invariant.  Returns the
// number of landmarks refreshed.
int32_t map_refresh_frame_points(MapStore* m, int32_t kf) {
  if (kf < 0 || kf >= m->n_kf_slots || !m->kf_active[kf]) return 0;
  size_t b = m->kp_base(kf);
  int32_t n = 0;
  for (int32_t kp = 0; kp < m->kf_nkp[kf]; ++kp) {
    int32_t pt = m->kp_pt[b + kp];
    if (pt < 0 || !m->pt_active[pt] || m->kp_outlier[b + kp]) continue;
    refresh_descriptor(m, pt);
    ++n;
  }
  return n;
}

// Export per-point observation lists for one point (for descriptor refresh /
// viewing-direction updates done by the Python layer).
int32_t map_point_observations(const MapStore* m, int32_t pt, int32_t* kf_out,
                               int32_t* kp_out, int32_t cap) {
  if (pt < 0 || pt >= m->n_pt_slots || !m->pt_active[pt]) return 0;
  int32_t n = 0;
  for (auto& o : m->pt_obs[pt]) {
    if (n < cap) { kf_out[n] = o.kf; kp_out[n] = o.kp; }
    ++n;
  }
  return n;
}

}  // extern "C"
