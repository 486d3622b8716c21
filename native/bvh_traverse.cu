// Skip-link BVH traversal, one ray per thread, as XLA FFI custom calls.
//
// Walks the same flattened arrays as render/bvh.py (depth-first nodes,
// skip links, LEAF_SIZE primitive slots per leaf) with the same
// primitive tests as render/geometry.py, so results match the plain JAX
// traversal. Each ray keeps its cursor and best hit in registers and
// stops on its own; no stack is needed.
//
// Built twice from this one file (mitsuba_customization_tpu/ops/traverse.py):
//   nvcc  -> CUDA handlers (one thread per ray), used on the GPU;
//   g++   -> host handlers (a loop over rays), used by the CPU tests to
//            check this code's arithmetic against the JAX reference.

#include <cmath>
#include <cstdint>

#include "xla/ffi/api/ffi.h"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __host__ __device__ __forceinline__
#else
#define HD inline
#endif

// Read-only loads through the non-coherent cache in device code.
#ifdef __CUDA_ARCH__
#define LDG(p) __ldg(p)
#else
#define LDG(p) (*(p))
#endif

namespace ffi = xla::ffi;

namespace {

constexpr int kLeafSize = 4;  // render/bvh.py LEAF_SIZE
constexpr int kTri = 0;       // render/geometry.py TRI / SPHERE / CYLINDER
constexpr int kCylinder = 2;
constexpr float kEps = 1e-7f;  // render/geometry.py _EPS
constexpr float kInf = INFINITY;

struct V3 {
  float x, y, z;
};

HD V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
HD V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
HD float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
HD V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
HD V3 load3(const float* p, int i) {
  return {LDG(p + 3 * i), LDG(p + 3 * i + 1), LDG(p + 3 * i + 2)};
}
HD float safe_inv(float x) { return x == 0.0f ? 0.0f : 1.0f / x; }

struct Tree {
  const int32_t* prim_type;
  const float* p0;
  const float* e1;
  const float* e2;
  const float* bb_min;
  const float* bb_max;
  const int32_t* skip;
  const int32_t* leaf;
  int32_t n_nodes;
};

// geometry.ray_triangle (Moller-Trumbore): t = inf on miss.
HD float ray_triangle(V3 o, V3 d, V3 p0, V3 e1, V3 e2, float* u, float* v) {
  V3 pvec = cross(d, e2);
  float det = dot(e1, pvec);
  float inv_det = safe_inv(det);
  V3 tvec = sub(o, p0);
  *u = dot(tvec, pvec) * inv_det;
  V3 qvec = cross(tvec, e1);
  *v = dot(d, qvec) * inv_det;
  float t = dot(e2, qvec) * inv_det;
  bool hit = fabsf(det) > kEps && *u >= 0.0f && *v >= 0.0f &&
             *u + *v <= 1.0f && t > 0.0f;
  return hit ? t : kInf;
}

// geometry.ray_sphere.
HD float ray_sphere(V3 o, V3 d, V3 c, float r) {
  V3 oc = sub(o, c);
  float b = dot(oc, d);
  float cc = dot(oc, oc) - r * r;
  float disc = b * b - cc;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float t0 = -b - sq;
  float t1 = -b + sq;
  float t = t0 > kEps ? t0 : t1;
  return (disc >= 0.0f && t > kEps) ? t : kInf;
}

// geometry.ray_cylinder: open lateral surface around p0..p0+axis.
HD float ray_cylinder(V3 o, V3 d, V3 p0, V3 axis, float radius) {
  float length = fmaxf(sqrtf(dot(axis, axis)), 1e-12f);
  V3 a = scale(axis, 1.0f / length);
  V3 oc = sub(o, p0);
  float d_par = dot(d, a);
  float oc_par = dot(oc, a);
  V3 dd = sub(d, scale(a, d_par));
  V3 oo = sub(oc, scale(a, oc_par));
  float qa = dot(dd, dd);
  float qb = dot(dd, oo);
  float qc = dot(oo, oo) - radius * radius;
  float disc = qb * qb - qa * qc;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float inv_a = safe_inv(qa);
  float t0 = (-qb - sq) * inv_a;
  float t1 = (-qb + sq) * inv_a;
  float s0 = oc_par + t0 * d_par;
  float s1 = oc_par + t1 * d_par;
  bool ok0 = t0 > kEps && s0 >= 0.0f && s0 <= length;
  bool ok1 = t1 > kEps && s1 >= 0.0f && s1 <= length;
  float t = ok0 ? t0 : (ok1 ? t1 : kInf);
  bool hit = disc >= 0.0f && qa > 1e-12f && (ok0 || ok1);
  return hit ? t : kInf;
}

// geometry._intersect_prims for one primitive: (t, u, v), t = inf on miss.
HD float ray_prim(const Tree& s, int pid, V3 o, V3 d, float* u, float* v) {
  int type = LDG(s.prim_type + pid);
  V3 p0 = load3(s.p0, pid);
  V3 e1 = load3(s.e1, pid);
  *u = 0.0f;
  *v = 0.0f;
  if (type == kTri) return ray_triangle(o, d, p0, e1, load3(s.e2, pid), u, v);
  if (type == kCylinder) return ray_cylinder(o, d, p0, e1, LDG(s.e2 + 3 * pid));
  return ray_sphere(o, d, p0, e1.x);
}

// bvh._slab_test.
HD bool slab(const Tree& s, int node, V3 o, V3 inv_d, float t_best) {
  V3 lo = load3(s.bb_min, node);
  V3 hi = load3(s.bb_max, node);
  float tx0 = (lo.x - o.x) * inv_d.x, tx1 = (hi.x - o.x) * inv_d.x;
  float ty0 = (lo.y - o.y) * inv_d.y, ty1 = (hi.y - o.y) * inv_d.y;
  float tz0 = (lo.z - o.z) * inv_d.z, tz1 = (hi.z - o.z) * inv_d.z;
  float near_t = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  float far_t = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return near_t <= far_t && far_t > 0.0f && near_t < t_best;
}

HD float inv_dir(float x) { return 1.0f / (fabsf(x) < 1e-12f ? 1e-12f : x); }

// bvh.intersect for one ray.
HD void closest_one(const Tree& s, V3 o, V3 d, float maxt, float* t_out,
                    int32_t* prim_out, float* u_out, float* v_out) {
  V3 inv_d = {inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)};
  float t_best = maxt;
  int32_t prim = -1;
  float ub = 0.0f, vb = 0.0f;
  int node = maxt > 0.0f ? 0 : s.n_nodes;  // maxt <= 0: nothing can hit
  while (node < s.n_nodes) {
    bool hit_box = slab(s, node, o, inv_d, t_best);
    const int32_t* leaf = s.leaf + kLeafSize * node;
    bool is_leaf = LDG(leaf) >= 0;
    if (hit_box && is_leaf) {
      for (int i = 0; i < kLeafSize; ++i) {
        int pid = LDG(leaf + i);
        if (pid < 0) continue;
        float u, v;
        float t = ray_prim(s, pid, o, d, &u, &v);
        if (t < t_best && t < maxt) {
          t_best = t;
          prim = pid;
          ub = u;
          vb = v;
        }
      }
    }
    node = (hit_box && !is_leaf) ? node + 1 : LDG(s.skip + node);
  }
  *t_out = prim < 0 ? kInf : t_best;
  *prim_out = prim;
  *u_out = ub;
  *v_out = vb;
}

// bvh.occluded for one ray: any primitive with t < maxt.
HD bool occluded_one(const Tree& s, V3 o, V3 d, float maxt) {
  V3 inv_d = {inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)};
  int node = maxt > 0.0f ? 0 : s.n_nodes;
  while (node < s.n_nodes) {
    bool hit_box = slab(s, node, o, inv_d, maxt);
    const int32_t* leaf = s.leaf + kLeafSize * node;
    bool is_leaf = LDG(leaf) >= 0;
    if (hit_box && is_leaf) {
      for (int i = 0; i < kLeafSize; ++i) {
        int pid = LDG(leaf + i);
        if (pid < 0) continue;
        float u, v;
        if (ray_prim(s, pid, o, d, &u, &v) < maxt) return true;
      }
    }
    node = (hit_box && !is_leaf) ? node + 1 : LDG(s.skip + node);
  }
  return false;
}

using F32 = ffi::Buffer<ffi::F32>;
using I32 = ffi::Buffer<ffi::S32>;

Tree make_tree(I32 prim_type, F32 p0, F32 e1, F32 e2, F32 bb_min, F32 bb_max,
               I32 skip, I32 leaf) {
  return Tree{prim_type.typed_data(), p0.typed_data(),   e1.typed_data(),
              e2.typed_data(),        bb_min.typed_data(), bb_max.typed_data(),
              skip.typed_data(),      leaf.typed_data(),
              static_cast<int32_t>(skip.element_count())};
}

#ifdef __CUDACC__

constexpr int kBlock = 128;

__global__ void closest_kernel(Tree s, const float* o, const float* d,
                               const float* maxt, int64_t n, float* t,
                               int32_t* prim, float* u, float* v) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  closest_one(s, load3(o, i), load3(d, i), maxt[i], t + i, prim + i, u + i,
              v + i);
}

__global__ void occluded_kernel(Tree s, const float* o, const float* d,
                                const float* maxt, int64_t n, bool* hit) {
  int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  hit[i] = occluded_one(s, load3(o, i), load3(d, i), maxt[i]);
}

ffi::Error launch_status() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error Closest(cudaStream_t stream, F32 o, F32 d, F32 maxt, I32 prim_type,
                   F32 p0, F32 e1, F32 e2, F32 bb_min, F32 bb_max, I32 skip,
                   I32 leaf, ffi::ResultBuffer<ffi::F32> t,
                   ffi::ResultBuffer<ffi::S32> prim,
                   ffi::ResultBuffer<ffi::F32> u,
                   ffi::ResultBuffer<ffi::F32> v) {
  int64_t n = maxt.element_count();
  if (n == 0) return ffi::Error::Success();
  Tree s = make_tree(prim_type, p0, e1, e2, bb_min, bb_max, skip, leaf);
  int64_t blocks = (n + kBlock - 1) / kBlock;
  closest_kernel<<<blocks, kBlock, 0, stream>>>(
      s, o.typed_data(), d.typed_data(), maxt.typed_data(), n,
      t->typed_data(), prim->typed_data(), u->typed_data(), v->typed_data());
  return launch_status();
}

ffi::Error Occluded(cudaStream_t stream, F32 o, F32 d, F32 maxt,
                    I32 prim_type, F32 p0, F32 e1, F32 e2, F32 bb_min,
                    F32 bb_max, I32 skip, I32 leaf,
                    ffi::ResultBuffer<ffi::PRED> hit) {
  int64_t n = maxt.element_count();
  if (n == 0) return ffi::Error::Success();
  Tree s = make_tree(prim_type, p0, e1, e2, bb_min, bb_max, skip, leaf);
  int64_t blocks = (n + kBlock - 1) / kBlock;
  occluded_kernel<<<blocks, kBlock, 0, stream>>>(
      s, o.typed_data(), d.typed_data(), maxt.typed_data(), n,
      hit->typed_data());
  return launch_status();
}

#else  // host build

ffi::Error Closest(F32 o, F32 d, F32 maxt, I32 prim_type, F32 p0, F32 e1,
                   F32 e2, F32 bb_min, F32 bb_max, I32 skip, I32 leaf,
                   ffi::ResultBuffer<ffi::F32> t,
                   ffi::ResultBuffer<ffi::S32> prim,
                   ffi::ResultBuffer<ffi::F32> u,
                   ffi::ResultBuffer<ffi::F32> v) {
  Tree s = make_tree(prim_type, p0, e1, e2, bb_min, bb_max, skip, leaf);
  int64_t n = maxt.element_count();
  for (int64_t i = 0; i < n; ++i) {
    closest_one(s, load3(o.typed_data(), i), load3(d.typed_data(), i),
                maxt.typed_data()[i], t->typed_data() + i,
                prim->typed_data() + i, u->typed_data() + i,
                v->typed_data() + i);
  }
  return ffi::Error::Success();
}

ffi::Error Occluded(F32 o, F32 d, F32 maxt, I32 prim_type, F32 p0, F32 e1,
                    F32 e2, F32 bb_min, F32 bb_max, I32 skip, I32 leaf,
                    ffi::ResultBuffer<ffi::PRED> hit) {
  Tree s = make_tree(prim_type, p0, e1, e2, bb_min, bb_max, skip, leaf);
  int64_t n = maxt.element_count();
  for (int64_t i = 0; i < n; ++i) {
    hit->typed_data()[i] =
        occluded_one(s, load3(o.typed_data(), i), load3(d.typed_data(), i),
                     maxt.typed_data()[i]);
  }
  return ffi::Error::Success();
}

#endif

}  // namespace

#ifdef __CUDACC__
#define MCT_BIND ffi::Ffi::Bind().Ctx<ffi::PlatformStream<cudaStream_t>>()
#else
#define MCT_BIND ffi::Ffi::Bind()
#endif

#define MCT_TREE_ARGS                                                     \
  .Arg<F32>().Arg<F32>().Arg<F32>().Arg<I32>().Arg<F32>().Arg<F32>()     \
      .Arg<F32>().Arg<F32>().Arg<F32>().Arg<I32>().Arg<I32>()

XLA_FFI_DEFINE_HANDLER_SYMBOL(MctBvhClosest, Closest,
                              MCT_BIND MCT_TREE_ARGS
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(MctBvhOccluded, Occluded,
                              MCT_BIND MCT_TREE_ARGS
                                  .Ret<ffi::Buffer<ffi::PRED>>());
