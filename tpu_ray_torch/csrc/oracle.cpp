// Native CPU oracle: multithreaded scalar re-execution of the reference
// path-trace algorithm with the port's counter-based RNG.
//
// The port's own copy of the JAX package's src/native/oracle.cpp: the same
// C ABI (oracle_render_pass), the same algorithm and the same float32
// operation order, plus one entry point that takes the camera basis from
// the caller (oracle_render_pass_basis). The reference keeps a scalar kernel (RenderTileScalar,
// reference main.cpp:497-640) as the live A/B oracle for its SIMD path;
// tpu_ray_torch/oracle/cpu_oracle.py re-executes it in NumPy but is too
// slow beyond ~64x64. This file is that algorithm compiled by g++ with
// -ffp-contract=off (no FMA contraction diverges from NumPy) behind a C
// ABI for ctypes (tpu_ray_torch/oracle/native.py), fast enough to hold the
// card's routes against it at full scene size. It is host code, never
// built by nvcc: kernels/build.py compiles only csrc/*.cu.
//
// The runtime around it is a lock-free tile work queue (std::atomic
// fetch-add over 32x32 tiles + std::thread pool), the same scheduling
// design as reference wasm/wasm.cpp:604-694 / win32/win32.cpp:204-295.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

typedef float f32;
typedef uint32_t u32;
typedef uint64_t u64;

constexpr f32 kEps = 1e-4f;    // reference base.h:889 (F32Epsilon)
constexpr f32 kMax = 1e30f;    // reference base.h:891 (F32Max)
constexpr int kTile = 32;      // reference main.cpp:9 (TileSize)

// ---- counter-based RNG: bit-identical to tpu_ray_torch/core/rng.py ----

inline u32 PcgHash(u32 x) {
  u32 state = x * 747796405u + 2891336453u;
  u32 shift = (state >> 28) + 4u;
  u32 word = ((state >> shift) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

inline u32 RayBase(u32 seed, u32 pixel, u32 sample) {
  u32 h = PcgHash(pixel * 0x9E3779B1u ^ seed);
  return PcgHash(h + sample * 0x85EBCA6Bu);
}

inline u32 DrawU32(u32 base, u32 bounce, u32 slot) {
  return PcgHash(base + bounce * 0x632BE59Bu + slot * 0xC2B2AE35u);
}

inline f32 DrawUniform(u32 base, u32 bounce, u32 slot, f32 lo, f32 hi) {
  constexpr f32 inv = 1.0f / 4294967296.0f;
  f32 scale = (hi - lo) * inv;
  return (f32)DrawU32(base, bounce, slot) * scale + lo;
}

// ---- small vector helpers (reference v3 semantics) ----

struct V3 { f32 x, y, z; };

inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
inline V3 operator*(f32 s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
inline f32 Dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// reference v3::Normalize (x64_math.h:234-245): zero when |v|^2 <= eps
inline V3 NormalizeEps(V3 v) {
  f32 lsq = Dot(v, v);
  if (!(lsq > kEps)) return {0.0f, 0.0f, 0.0f};
  f32 inv = 1.0f / sqrtf(lsq);
  return inv * v;
}

inline f32 Schlick(f32 cos_theta, f32 ri) {
  // reference Reflectance (main.cpp:292-300)
  f32 r0 = (1.0f - ri) / (1.0f + ri);
  r0 = r0 * r0;
  f32 r1 = 1.0f - cos_theta;
  r1 = r1 * r1 * r1 * r1 * r1;
  return r0 + (1.0f - r0) * r1;
}

struct SceneView {
  const f32* center;    // [N,3]
  const f32* radius;    // [N]
  const f32* albedo;    // [N,3]
  const f32* emissive;  // [N,3]
  const f32* specular;  // [N]
  const f32* ior;       // [N]
  int n;
  bool use_sky;
  // optional triangle soup (SoA, pre-differenced: v0, e1=v1-v0, e2=v2-v0;
  // padding triangles have e1=e2=0 => det=0 => never hit) — the scalar
  // re-execution of ops/intersect_tri (Möller-Trumbore 1997)
  const f32* tv0;        // [M,3] (nullptr when m == 0)
  const f32* te1;        // [M,3]
  const f32* te2;        // [M,3]
  const f32* t_albedo;   // [M,3]
  const f32* t_emissive; // [M,3]
  const f32* t_specular; // [M]
  const f32* t_ior;      // [M]
  int m;
};

inline V3 Row3(const f32* a, int i) { return {a[3*i], a[3*i+1], a[3*i+2]}; }

// nearest hit: brute force, first-min tie rule (== np.argmin / reference
// FindFirstIndex x64_math.h:585-592)
inline bool Nearest(const SceneView& s, V3 o, V3 d,
                    f32* t_out, int* i_out, bool* inside_out) {
  f32 best = kMax;
  int best_i = 0;
  bool best_inside = false;
  for (int i = 0; i < s.n; ++i) {
    V3 m = Row3(s.center, i) - o;
    f32 t_proj = Dot(m, d);
    V3 p = m - t_proj * d;
    f32 dsq = Dot(p, p);
    f32 r2 = s.radius[i] * s.radius[i];
    if (!(dsq < r2)) continue;
    f32 x = sqrtf(r2 - dsq > 0.0f ? r2 - dsq : 0.0f);
    f32 t_near = t_proj - x;
    bool inside = t_near < kEps;
    f32 t = inside ? t_proj + x : t_near;
    if (!(t > kEps)) continue;
    if (t < best) { best = t; best_i = i; best_inside = inside; }
  }
  *t_out = best;
  *i_out = best_i;
  *inside_out = best_inside;
  return best < kMax;
}

// one pixel sample: reference RenderTileScalar bounce loop
// (main.cpp:539-626), identical op order to oracle/cpu_oracle.py
inline V3 Cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

// nearest triangle: Möller-Trumbore, no backface culling, first-min ties
// (same semantics as ops/intersect_tri.nearest_hit_tri)
inline bool NearestTri(const SceneView& s, V3 o, V3 d,
                       f32* t_out, int* i_out, bool* inside_out) {
  constexpr f32 kDetEps = 1e-9f;
  f32 best = kMax;
  int best_i = 0;
  bool best_inside = false;
  for (int i = 0; i < s.m; ++i) {
    V3 e1 = Row3(s.te1, i), e2 = Row3(s.te2, i);
    V3 pvec = Cross(d, e2);
    f32 det = Dot(e1, pvec);
    f32 adet = det < 0.0f ? -det : det;
    if (!(adet > kDetEps)) continue;
    f32 inv = 1.0f / det;
    V3 tvec = o - Row3(s.tv0, i);
    f32 u = Dot(tvec, pvec) * inv;
    if (u < 0.0f) continue;
    V3 qvec = Cross(tvec, e1);
    f32 v = Dot(d, qvec) * inv;
    if (v < 0.0f || u + v > 1.0f) continue;
    f32 t = Dot(e2, qvec) * inv;
    if (!(t > kEps)) continue;
    if (t < best) {
      best = t; best_i = i;
      // backface hit counts as "inside" (reference main.cpp:456-458 rule)
      best_inside = Dot(d, Cross(e1, e2)) > 0.0f;
    }
  }
  *t_out = best;
  *i_out = best_i;
  *inside_out = best_inside;
  return best < kMax;
}

inline int TracePixel(const SceneView& s, V3 o, V3 d, u32 base,
                      int max_bounces, V3* color_out) {
  V3 atten = {1.0f, 1.0f, 1.0f};
  V3 color = {0.0f, 0.0f, 0.0f};
  int rays = 0;
  for (int b = 0; b < max_bounces; ++b) {
    ++rays;
    f32 tmin; int i; bool inside;
    bool hit = Nearest(s, o, d, &tmin, &i, &inside);
    bool is_tri = false;
    if (s.m > 0) {
      f32 tt; int j; bool ins_t;
      if (NearestTri(s, o, d, &tt, &j, &ins_t) && tt < tmin) {
        // strict <: the sphere wins exact ties (merge_payloads rule)
        tmin = tt; i = j; inside = ins_t; is_tri = true; hit = true;
      }
    }
    if (!hit) {
      if (s.use_sky) {  // sky gradient (reference main.cpp:581-588)
        f32 a = (d.y + 1.0f) * 0.5f;
        V3 sky = (1.0f - a) * V3{1.0f, 1.0f, 1.0f}
                 + a * V3{0.5f, 0.7f, 1.0f};
        color = color + sky * atten;
      }
      break;
    }

    V3 point = tmin * d;
    V3 next_o = o + point;
    V3 normal_raw, emissive, albedo;
    f32 spec, ior;
    if (is_tri) {
      normal_raw = Cross(Row3(s.te1, i), Row3(s.te2, i));
      emissive = Row3(s.t_emissive, i);
      albedo = Row3(s.t_albedo, i);
      spec = s.t_specular[i];
      ior = s.t_ior[i];
    } else {
      V3 c = Row3(s.center, i);
      normal_raw = point - (c - o);
      emissive = Row3(s.emissive, i);
      albedo = Row3(s.albedo, i);
      spec = s.specular[i];
      ior = s.ior[i];
    }

    color = color + emissive * atten;
    atten = atten * albedo;
    o = next_o;

    V3 normal = NormalizeEps(normal_raw);
    V3 pure = d - 2.0f * Dot(d, normal) * normal;
    V3 n2 = inside ? -normal : normal;

    if (ior == 0.0f) {
      // diffuse/specular mix (reference main.cpp:605-609)
      V3 rv = {DrawUniform(base, b, 0, -1.0f, 1.0f),
               DrawUniform(base, b, 1, -1.0f, 1.0f),
               DrawUniform(base, b, 2, -1.0f, 1.0f)};
      V3 rb = n2 + NormalizeEps(rv);
      d = NormalizeEps((1.0f - spec) * rb + spec * pure);
    } else {
      // dielectric (reference main.cpp:610-626)
      f32 ri = inside ? ior : 1.0f / ior;
      f32 cos_t = -Dot(d, n2); if (cos_t > 1.0f) cos_t = 1.0f;
      f32 s2 = 1.0f - cos_t * cos_t;
      f32 sin_t = sqrtf(s2 > 0.0f ? s2 : 0.0f);
      bool cant = ri * sin_t > 1.0f;
      V3 perp = ri * (d + cos_t * n2);
      f32 k = 1.0f - Dot(perp, perp);
      V3 par = -sqrtf(k < 0.0f ? -k : k) * n2;
      V3 refr = NormalizeEps(perp + par);
      f32 rr = DrawUniform(base, b, 3, 0.0f, 1.0f);
      d = ((cant || Schlick(cos_t, ri) > rr) && !inside) ? pure : refr;
    }
  }
  *color_out = color;
  return rays;
}

struct Job {
  SceneView scene;
  V3 pos, cam_x, cam_y, film_center;
  f32 film_w, film_h;
  int width, height, spp, sample_start, max_bounces;
  u32 seed;
  f32* out_image;  // [H*W*3] sample sums
  std::atomic<u32> next_tile{0};
  std::atomic<u64> total_rays{0};
  int tiles_x, tiles_y;
};

// tile worker: the reference's ThreadFunction fetch-add loop
// (wasm/wasm.cpp:624-642) over 32x32 tiles (main.cpp:824-838)
void Worker(Job* job) {
  const int n_tiles = job->tiles_x * job->tiles_y;
  u64 rays_local = 0;
  for (;;) {
    u32 tile = job->next_tile.fetch_add(1, std::memory_order_relaxed);
    if ((int)tile >= n_tiles) break;
    int tx = (tile % job->tiles_x) * kTile;
    int ty = (tile / job->tiles_x) * kTile;
    int x1 = tx + kTile < job->width ? tx + kTile : job->width;
    int y1 = ty + kTile < job->height ? ty + kTile : job->height;
    for (int py = ty; py < y1; ++py) {
      for (int px = tx; px < x1; ++px) {
        int pix = py * job->width + px;
        V3 acc = {0.0f, 0.0f, 0.0f};
        for (int s = job->sample_start;
             s < job->sample_start + job->spp; ++s) {
          u32 base = RayBase(job->seed, (u32)pix, (u32)s);
          f32 jx = DrawUniform(base, 0, 4, -0.5f, 0.5f);
          f32 jy = DrawUniform(base, 0, 5, -0.5f, 0.5f);
          f32 film_x = -1.0f + (((f32)px + jx) * 2.0f) / (f32)job->width;
          f32 film_y = -1.0f + (((f32)py + jy) * 2.0f) / (f32)job->height;
          V3 film_p = job->film_center
                      + (film_x * job->film_w * 0.5f) * job->cam_x
                      + (film_y * job->film_h * 0.5f) * job->cam_y;
          V3 d = NormalizeEps(film_p - job->pos);
          V3 color;
          rays_local += TracePixel(job->scene, job->pos, d, base,
                                   job->max_bounces, &color);
          acc = acc + color;
        }
        job->out_image[3*pix]   += acc.x;
        job->out_image[3*pix+1] += acc.y;
        job->out_image[3*pix+2] += acc.z;
      }
    }
  }
  job->total_rays.fetch_add(rays_local, std::memory_order_relaxed);
}

// the pass over the film, on n_threads threads, for a camera basis (x, y
// the film's axes, z from the target to the camera)
u64 RenderPass(const SceneView& scene, V3 pos, V3 x, V3 y, V3 z,
               int width, int height, int spp, int sample_start,
               u32 seed, int max_bounces, int n_threads, f32* out_image) {
  Job job;
  job.scene = scene;
  job.pos = pos;
  job.cam_x = x;
  job.cam_y = y;
  job.film_center = pos - z;
  job.film_w = 1.0f;
  job.film_h = 1.0f;
  if (width > height) job.film_h = (f32)height / (f32)width;
  else job.film_w = (f32)width / (f32)height;

  job.width = width; job.height = height;
  job.spp = spp; job.sample_start = sample_start;
  job.max_bounces = max_bounces; job.seed = seed;
  job.out_image = out_image;
  job.tiles_x = (width + kTile - 1) / kTile;
  job.tiles_y = (height + kTile - 1) / kTile;

  if (n_threads < 1) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  for (int i = 1; i < n_threads; ++i) pool.emplace_back(Worker, &job);
  Worker(&job);  // main thread participates (like win32/win32.cpp:277-295)
  for (auto& t : pool) t.join();
  return job.total_rays.load();
}

}  // namespace

extern "C" {

// Renders `spp` jittered samples per pixel into out_image (ADDS sample sums,
// caller zeroes). Returns total rays cast (the reference's metric,
// main.cpp:390). Semantics identical to CpuOracle.render_pass.
u64 oracle_render_pass(
    const f32* center, const f32* radius, const f32* albedo,
    const f32* emissive, const f32* specular, const f32* ior,
    int n_spheres, int use_sky,
    const f32* tv0, const f32* te1, const f32* te2,
    const f32* t_albedo, const f32* t_emissive, const f32* t_specular,
    const f32* t_ior, int n_tris,
    const f32* cam_pos, const f32* look_at,
    int width, int height, int spp, int sample_start,
    u32 seed, int max_bounces, int n_threads,
    f32* out_image) {
  SceneView scene = {center, radius, albedo, emissive, specular, ior,
                     n_spheres, use_sky != 0,
                     tv0, te1, te2, t_albedo, t_emissive, t_specular, t_ior,
                     n_tris};

  // camera basis (reference main.cpp:811-822)
  V3 pos = {cam_pos[0], cam_pos[1], cam_pos[2]};
  V3 tgt = {look_at[0], look_at[1], look_at[2]};
  V3 z = pos - tgt;
  z = (1.0f / sqrtf(Dot(z, z))) * z;
  V3 up = {0.0f, 1.0f, 0.0f};
  V3 x = {up.y * z.z - up.z * z.y,
          up.z * z.x - up.x * z.z,
          up.x * z.y - up.y * z.x};
  x = (1.0f / sqrtf(Dot(x, x))) * x;
  V3 y = {z.y * x.z - z.z * x.y,
          z.z * x.x - z.x * x.z,
          z.x * x.y - z.y * x.x};
  y = (1.0f / sqrtf(Dot(y, y))) * y;

  return RenderPass(scene, pos, x, y, z, width, height, spp, sample_start,
                    seed, max_bounces, n_threads, out_image);
}

// oracle_render_pass with the camera basis given by the caller: basis holds
// x, y, z (9 floats), as a renderer under test computed them from the same
// position and target. The basis above multiplies by a reciprocal root
// where the port's camera divides, which can differ in the last bit; given
// the port's basis the pass repeats the port's f32 ops.
u64 oracle_render_pass_basis(
    const f32* center, const f32* radius, const f32* albedo,
    const f32* emissive, const f32* specular, const f32* ior,
    int n_spheres, int use_sky,
    const f32* tv0, const f32* te1, const f32* te2,
    const f32* t_albedo, const f32* t_emissive, const f32* t_specular,
    const f32* t_ior, int n_tris,
    const f32* cam_pos, const f32* basis,
    int width, int height, int spp, int sample_start,
    u32 seed, int max_bounces, int n_threads,
    f32* out_image) {
  SceneView scene = {center, radius, albedo, emissive, specular, ior,
                     n_spheres, use_sky != 0,
                     tv0, te1, te2, t_albedo, t_emissive, t_specular, t_ior,
                     n_tris};
  V3 pos = {cam_pos[0], cam_pos[1], cam_pos[2]};
  return RenderPass(scene, pos, Row3(basis, 0), Row3(basis, 1),
                    Row3(basis, 2), width, height, spp, sample_start, seed,
                    max_bounces, n_threads, out_image);
}

}  // extern "C"
