// Native problem compiler for bundle_adjustment_solver.
//
// Host-side runtime work that sits between user registration and the static
// device arrays the solvers consume. The reference does the equivalent
// in C++ with pointer-keyed hash maps and serial passes
// (FinalizeParameters / SetProblemSize / connectivity maps,
// core/full_bundle_adjustment_solver.cpp:182-341, 669-700); at millions of
// observations these passes dominate setup time in Python, so they are
// native here too:
//
//   ba_sort_by_segments     -- stable counting sort of observations by
//                              (point_opt, pose_opt): the segment layout
//                              every downstream segment_sum relies on.
//   ba_connectivity         -- unique-pair counts: points seen per pose and
//                              poses seeing each point (the reference's
//                              CheckPoseAndPointConnectivity warning data).
//   ba_partition_landmarks  -- contiguous observation-balanced landmark
//                              partition for the multi-device sharding.
//
// Compiled as a plain C shared library (no pybind11 in this image); loaded
// via ctypes with a pure-numpy fallback (see utils/native.py).

#include <cstdint>
#include <cstring>
#include <vector>

// Shared scaffold of the stable two-pass LSD counting sort by
// (point_opt, pose_opt): fills `tmp` with row ids ordered by pose_opt
// (pass 1) and `count` with the running point_opt bucket cursors, leaving
// pass 2's per-row output action to the caller (iterate i over tmp, place
// row at count[point_opt[tmp[i]]]++).
static bool sort_segment_passes(const int32_t* point_opt,
                                const int32_t* pose_opt, int64_t n,
                                int64_t num_point_keys,
                                int64_t num_pose_keys,
                                std::vector<int64_t>& tmp,
                                std::vector<int64_t>& count) {
  if (n < 0 || num_point_keys <= 0 || num_pose_keys <= 0) return false;
  tmp.resize(static_cast<size_t>(n));
  {
    std::vector<int64_t> c(static_cast<size_t>(num_pose_keys) + 1, 0);
    for (int64_t i = 0; i < n; ++i) c[pose_opt[i] + 1]++;
    for (int64_t k = 0; k < num_pose_keys; ++k) c[k + 1] += c[k];
    for (int64_t i = 0; i < n; ++i) tmp[c[pose_opt[i]]++] = i;
  }
  count.assign(static_cast<size_t>(num_point_keys) + 1, 0);
  for (int64_t i = 0; i < n; ++i) count[point_opt[i] + 1]++;
  for (int64_t k = 0; k < num_point_keys; ++k) count[k + 1] += count[k];
  return true;
}

extern "C" {

// Bump when an entry point's CONTRACT changes (not merely on additions):
// the Python loader refuses a library whose version it doesn't expect, so
// a stale cached .so (read-only checkout, failed rebuild) degrades to the
// numpy fallbacks instead of silently running old semantics -- e.g. a
// pre-duplicate-detection ba_pm_fill would silently overwrite sibling
// residuals now that the caller no longer runs its own uniqueness check.
int64_t ba_abi_version(void) { return 2; }

// Stable counting sort of [0, n) observation rows by key
// point_opt * (num_pose_keys) + pose_opt. Keys must be in range
// (point_opt <= num_point_keys-1, pose_opt <= num_pose_keys-1).
// Writes the permutation into order_out (int64).
int ba_sort_by_segments(const int32_t* point_opt, const int32_t* pose_opt,
                        int64_t n, int64_t num_point_keys,
                        int64_t num_pose_keys, int64_t* order_out) {
  std::vector<int64_t> tmp, count;
  if (!sort_segment_passes(point_opt, pose_opt, n, num_point_keys,
                           num_pose_keys, tmp, count))
    return -1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t row = tmp[static_cast<size_t>(i)];
    order_out[count[point_opt[row]]++] = row;
  }
  return 0;
}

// Fused counting-sort + permute of the observation table
// (models/problem.finalized_from_arrays' hot path). Sorts rows stably by
// (point_opt, pose_opt) and writes every column already permuted -- the
// explicit order array and the per-column numpy fancy-index gathers never
// materialize. pixel rows are scaled by pixel_scale on the way through
// (the reference's scaler_ conditioning, full cpp:72-80). pose_opt_out /
// point_opt_out receive the permuted sort keys.
int ba_finalize_obs(const int32_t* point_opt, const int32_t* pose_opt,
                    const int32_t* cam, const int32_t* pose,
                    const int32_t* point, const double* pixel /* (n,2) */,
                    double pixel_scale, int64_t n, int64_t num_point_keys,
                    int64_t num_pose_keys, int32_t* cam_out,
                    int32_t* pose_out, int32_t* point_out,
                    double* pixel_out, int32_t* pose_opt_out,
                    int32_t* point_opt_out) {
  std::vector<int64_t> tmp, count;
  if (!sort_segment_passes(point_opt, pose_opt, n, num_point_keys,
                           num_pose_keys, tmp, count))
    return -1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t row = tmp[static_cast<size_t>(i)];
    const int64_t dst = count[point_opt[row]]++;
    cam_out[dst] = cam[row];
    pose_out[dst] = pose[row];
    point_out[dst] = point[row];
    pixel_out[dst * 2 + 0] = pixel[row * 2 + 0] * pixel_scale;
    pixel_out[dst * 2 + 1] = pixel[row * 2 + 1] * pixel_scale;
    pose_opt_out[dst] = pose_opt[row];
    point_opt_out[dst] = point_opt[row];
  }
  return 0;
}

// Unique-pair connectivity counts. Inputs need NOT be sorted.
// points_per_pose[j] = #distinct points observed by pose j;
// poses_per_point[i] = #distinct poses observing point i.
// Uses a last-seen stamp array: O(n + N + M) time, no hashing.
int ba_connectivity(const int32_t* obs_pose, const int32_t* obs_point,
                    int64_t n, int64_t num_poses, int64_t num_points,
                    int32_t* points_per_pose, int32_t* poses_per_point) {
  if (n < 0 || num_poses <= 0 || num_points <= 0) return -1;
  std::memset(points_per_pose, 0, sizeof(int32_t) * num_poses);
  std::memset(poses_per_point, 0, sizeof(int32_t) * num_points);
  // Count unique pairs by sorting-by-point via counting sort buckets, then
  // a stamp per pose within each point's run (and vice versa).
  std::vector<int64_t> start(static_cast<size_t>(num_points) + 1, 0);
  for (int64_t i = 0; i < n; ++i) start[obs_point[i] + 1]++;
  for (int64_t k = 0; k < num_points; ++k) start[k + 1] += start[k];
  std::vector<int32_t> pose_of(static_cast<size_t>(n));
  {
    std::vector<int64_t> cursor(start.begin(), start.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      pose_of[cursor[obs_point[i]]++] = obs_pose[i];
  }
  std::vector<int64_t> stamp(static_cast<size_t>(num_poses), -1);
  for (int64_t p = 0; p < num_points; ++p) {
    for (int64_t k = start[p]; k < start[p + 1]; ++k) {
      const int32_t j = pose_of[static_cast<size_t>(k)];
      if (stamp[j] != p) {
        stamp[j] = p;
        poses_per_point[p]++;
        points_per_pose[j]++;
      }
    }
  }
  return 0;
}

// --- Point-major layout builder (models/layout.py's hot loops) -----------
//
// Two-call protocol so Python controls allocation:
//   ba_pm_probe  -- per-point unique-pose slot counts + min observing pose;
//                   returns the maximum slot count (Kp before padding).
//   ba_pm_fill   -- scatter observations into the padded cam-major planes.
// Serial O(n) passes with counting-sort buckets; 12M observations build in
// ~1 s where the vectorized-numpy fallback takes ~35 s.

// slot_count_out (M,), min_pose_out (M,). Returns max slots, or -1 on error.
int64_t ba_pm_probe(const int32_t* obs_pose, const int32_t* obs_point,
                    int64_t n, int64_t num_points, int64_t num_poses,
                    int32_t* slot_count_out, int32_t* min_pose_out) {
  if (n < 0 || num_points <= 0 || num_poses <= 0) return -1;
  std::vector<int64_t> start(static_cast<size_t>(num_points) + 1, 0);
  for (int64_t i = 0; i < n; ++i) start[obs_point[i] + 1]++;
  for (int64_t k = 0; k < num_points; ++k) start[k + 1] += start[k];
  std::vector<int32_t> pose_of(static_cast<size_t>(n));
  {
    std::vector<int64_t> cursor(start.begin(), start.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      pose_of[cursor[obs_point[i]]++] = obs_pose[i];
  }
  std::vector<int64_t> stamp(static_cast<size_t>(num_poses), -1);
  int64_t kp_max = 0;
  for (int64_t p = 0; p < num_points; ++p) {
    int32_t slots = 0;
    int32_t mn = static_cast<int32_t>(num_poses);
    for (int64_t k = start[p]; k < start[p + 1]; ++k) {
      const int32_t j = pose_of[static_cast<size_t>(k)];
      if (j < mn) mn = j;
      if (stamp[j] != p) {
        stamp[j] = p;
        slots++;
      }
    }
    slot_count_out[p] = slots;
    min_pose_out[p] = mn;  // num_poses when the point has no observations
    if (slots > kp_max) kp_max = slots;
  }
  return kp_max;
}

// Fill the padded cam-major planes. rank_of_point maps point id -> padded
// landmark row (from Python's stable argsort by min_pose). Slots within a
// point are assigned in ascending pose order (insertion into a tiny sorted
// array -- slot counts are <= max_slots). All outputs must be pre-zeroed
// except slot_opt (pre-filled -1) and point_ref (pre-filled -1).
int ba_pm_fill(const int32_t* obs_pose, const int32_t* obs_point,
               const int32_t* obs_cam, const double* obs_pixel /* (n,2) */,
               const double* points /* (M,3) */,
               const int32_t* pose_opt_of /* (N,) sentinel n_opt */,
               const uint8_t* point_is_opt /* (M,) */,
               const int32_t* rank_of_point /* (M,) */,
               int64_t n, int64_t num_points, int64_t num_poses,
               int64_t n_opt, int64_t num_cams, int64_t kp, int64_t mp,
               float* u_plane /* (kp*C, mp) */, float* v_plane,
               float* valid_plane, int32_t* slot_pose /* (kp, mp) */,
               int32_t* slot_opt /* (kp, mp) */, float* X /* (4, mp) */,
               int32_t* point_ref /* (mp,) */) {
  if (n < 0 || num_points <= 0 || kp <= 0 || mp <= 0) return -1;
  // Bucket observation ids by point.
  std::vector<int64_t> start(static_cast<size_t>(num_points) + 1, 0);
  for (int64_t i = 0; i < n; ++i) start[obs_point[i] + 1]++;
  for (int64_t k = 0; k < num_points; ++k) start[k + 1] += start[k];
  std::vector<int64_t> obs_of(static_cast<size_t>(n));
  {
    std::vector<int64_t> cursor(start.begin(), start.end() - 1);
    for (int64_t i = 0; i < n; ++i) obs_of[cursor[obs_point[i]]++] = i;
  }

  // Per-point work writes only that point's padded row (rank_of_point is a
  // permutation), so points parallelize with no synchronization beyond the
  // shared error flag. The flag is accessed with omp atomics (a plain
  // concurrent read/write is a data race); when DIFFERENT errors race the
  // surviving code is arbitrary, which is safe: every nonzero code routes
  // the caller off the native path, and the numpy fallback re-runs its own
  // duplicate check.
  int err = 0;
#if defined(_OPENMP)
#pragma omp parallel
#endif
  {
    std::vector<int32_t> run_poses(static_cast<size_t>(kp));
#if defined(_OPENMP)
#pragma omp for schedule(dynamic, 2048)
#endif
    for (int64_t p = 0; p < num_points; ++p) {
      int err_seen;
#if defined(_OPENMP)
#pragma omp atomic read
#endif
      err_seen = err;
      if (err_seen) continue;
      const int64_t row = rank_of_point[p];
      point_ref[row] = static_cast<int32_t>(p);
      X[row] = static_cast<float>(points[p * 3 + 0]);
      X[mp + row] = static_cast<float>(points[p * 3 + 1]);
      X[2 * mp + row] = static_cast<float>(points[p * 3 + 2]);
      X[3 * mp + row] = point_is_opt[p] ? 1.0f : 0.0f;

      // Collect the distinct observing poses in ascending order.
      int perr = 0;  // this point's error; published to `err` atomically
      int64_t nslots = 0;
      for (int64_t k = start[p]; k < start[p + 1]; ++k) {
        const int32_t j = obs_pose[obs_of[static_cast<size_t>(k)]];
        int64_t lo = 0;
        while (lo < nslots && run_poses[lo] < j) lo++;
        if (lo < nslots && run_poses[lo] == j) continue;
        if (nslots >= kp) {  // caller sized kp too small
          perr = -2;
          break;
        }
        for (int64_t m = nslots; m > lo; --m) run_poses[m] = run_poses[m - 1];
        run_poses[lo] = j;
        nslots++;
      }
      if (!perr) {
        for (int64_t s = 0; s < nslots; ++s) {
          const int32_t j = run_poses[s];
          slot_pose[s * mp + row] = j;
          const int32_t opt = pose_opt_of[j];
          slot_opt[s * mp + row] = (opt == n_opt) ? -1 : opt;
        }
        // Scatter pixels into the cam-major planes.
        for (int64_t k = start[p]; k < start[p + 1]; ++k) {
          const int64_t o = obs_of[static_cast<size_t>(k)];
          const int32_t j = obs_pose[o];
          int64_t s = 0;
          while (run_poses[s] != j) s++;
          const int64_t c = obs_cam[o];
          if (c < 0 || c >= num_cams) {
            perr = -3;
            break;
          }
          const int64_t plane_row = c * kp + s;
          if (valid_plane[plane_row * mp + row] != 0.0f) {
            // Duplicate (point, pose, camera) observation: the plane
            // layout has exactly one cell per (slot, camera), so a
            // duplicate would silently overwrite its sibling residual.
            // Report it so the caller falls back to the observation-table
            // engine (which, like the reference's AddObservation append,
            // keeps both residuals).
            perr = -4;
            break;
          }
          u_plane[plane_row * mp + row] =
              static_cast<float>(obs_pixel[o * 2 + 0]);
          v_plane[plane_row * mp + row] =
              static_cast<float>(obs_pixel[o * 2 + 1]);
          valid_plane[plane_row * mp + row] = 1.0f;
        }
      }
      if (perr) {
#if defined(_OPENMP)
#pragma omp atomic write
#endif
        err = perr;
      }
    }
  }
  return err;
}

// Per-block pose/opt-index windows for the point-major gather kernels
// (models/layout.py's post-fill reduction). For each landmark block b of bm
// padded rows:
//   gmin/gmax over slot_pose cells whose (slot, row) has any valid camera
//   observation; smin/smax over slot_opt cells >= 0.
// Empty blocks report gmin=INT32_MAX/gmax=-1 (resp. smin/smax) and are
// resolved by the Python caller. valid_plane is (kp*C, mp) cam-major.
int ba_pm_windows(const int32_t* slot_pose, const int32_t* slot_opt,
                  const float* valid_plane, int64_t kp, int64_t num_cams,
                  int64_t mp, int64_t bm, int32_t* gmin_out,
                  int32_t* gmax_out, int32_t* smin_out, int32_t* smax_out) {
  if (kp <= 0 || num_cams <= 0 || mp <= 0 || bm <= 0 || mp % bm != 0)
    return -1;
  const int64_t nblocks = mp / bm;
  const int32_t I32MAX = 2147483647;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t b = 0; b < nblocks; ++b) {
    int32_t gmin = I32MAX, gmax = -1, smin = I32MAX, smax = -1;
    const int64_t m0 = b * bm;
    for (int64_t s = 0; s < kp; ++s) {
      const int32_t* sp = slot_pose + s * mp + m0;
      const int32_t* so = slot_opt + s * mp + m0;
      for (int64_t m = 0; m < bm; ++m) {
        bool has_obs = false;
        for (int64_t c = 0; c < num_cams; ++c) {
          if (valid_plane[(c * kp + s) * mp + m0 + m] != 0.0f) {
            has_obs = true;
            break;
          }
        }
        if (has_obs) {
          const int32_t j = sp[m];
          if (j < gmin) gmin = j;
          if (j > gmax) gmax = j;
        }
        const int32_t o = so[m];
        if (o >= 0) {
          if (o < smin) smin = o;
          if (o > smax) smax = o;
        }
      }
    }
    gmin_out[b] = gmin;
    gmax_out[b] = gmax;
    smin_out[b] = smin;
    smax_out[b] = smax;
  }
  return 0;
}

// Greedy contiguous landmark partition balancing observation counts.
// obs_per_point: (M,) observation count per point id.
// boundaries_out: (num_shards + 1,) point-id cut points
// (boundaries_out[0] == 0, boundaries_out[num_shards] == M).
int ba_partition_landmarks(const int64_t* obs_per_point, int64_t num_points,
                           int64_t total_obs, int64_t num_shards,
                           int64_t* boundaries_out) {
  if (num_points < 0 || num_shards <= 0) return -1;
  boundaries_out[0] = 0;
  const double target = static_cast<double>(total_obs) / num_shards;
  int64_t next = 1;
  int64_t acc = 0;
  for (int64_t p = 0; p < num_points && next < num_shards; ++p) {
    acc += obs_per_point[p];
    if (static_cast<double>(acc) >= target * next) {
      boundaries_out[next++] = p + 1;
    }
  }
  while (next <= num_shards) boundaries_out[next++] = num_points;
  return 0;
}

}  // extern "C"
