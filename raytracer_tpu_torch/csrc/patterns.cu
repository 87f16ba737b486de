// pattern_color_kernel: the base colour of every shading point of a level,
// its pattern's colour or its material's, in one launch.
//
// Replaces no TPU kernel. The JAX package evaluates patterns in XLA
// (raytracer_tpu/core/patterns.py::pattern_color, selected in
// raytracer_tpu/core/render.py's shade_level), which fuses the chain into a
// few loops. The port's plain version (raytracer_tpu_torch/core/
// patterns.py::pattern_color, then a torch.where on the pattern id) runs
// every pattern kind for every row and selects the row's own: 304 PyTorch
// kernels a level body in a CUDA graph on the H100, table_gather launches
// among them, whatever the scene holds. On the card a frame's level steps
// are bound by the count of their kernels (about 1.5 us of device time
// each), not by their bytes, so this kernel takes the whole stage into one
// launch.
// Python side: raytracer_tpu_torch/ops/patterns_cuda.py (the wrapper and
// the route: only where no gradient is needed, the kernel having no
// backward); the plain version is render.base_color_plain.
//
// What it computes, for each row r (core/patterns.py, patterns.rs):
//   pid = (int) rows[r, pid_col]   (the row's pattern id, -1 for none)
//   pid < 0:  out[r] = mat[r, 0:3]   (no pattern table is read)
//   else:     p = pat_inv[pid] (inv over[r]), inv the row's 4x4 from
//             column inv_col, both as mat3_apply + the translation
//             column, and out[r] = the colour
//             of pattern kind pat_kind[pid] at p: striped, gradient, ring,
//             checker, xyz, texture (a uv map, then a uv checker, align
//             check or image) or cube map (a face, its uv, its uv pattern).
// Indices into the tables are clamped to the tables, as table_gather
// clamps them.
//
// Exactness. The result has the bits of PyTorch's CUDA kernels for the
// plain chain, so frames do not move:
// * built with -fmad=false: no multiply-add is contracted that PyTorch
//   runs as two kernels; the three the chain does fuse (mat3_apply's
//   column steps, torch.addcmul) are written as fmaf, in its order;
// * torch.remainder on floats is fmod, then the divisor added where the
//   signs differ (PyTorch's CUDA kernel); Rust's % is x - trunc(x/m) m;
// * a division by a Python scalar is, on the card, a product with the
//   scalar's f32 reciprocal (PyTorch's div_true kernel): 1/(2 pi) and 1/pi
//   arrive rounded so from the wrapper, and x / 2 is x * 0.5 exactly;
// * IEEE division and sqrt (nvcc's defaults), atan2f, acosf, floorf,
//   truncf; clamp and maximum keep a NaN as PyTorch's do;
// * the cube map's faces in the reference's if-chain order (Right, Left,
//   Up, Down, Front, else Back), the image lookup's clamps as the plain
//   version's.
//
// What bounds it on an H100. A row reads its point (12 bytes), its
// pattern id and inverse transform (52 of its 108-byte shading row) or its
// material colour (12), and writes 12 bytes; the tables are a few hundred
// bytes and stay in L1 and L2 (an image is read a texel a row). A level
// body of 16,384 rows moves under 1.5 MB: under half a microsecond at
// 3.35 TB/s, under the 2 to 3 us a launch costs. One thread a row, 256 a
// CTA; a row runs only its own pattern kind's arithmetic (a switch), so
// the warps of a level of one pattern kind do not diverge, and the rows
// without a pattern only copy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// core/types.py: pattern kinds, uv mappings, uv pattern kinds
enum { STRIPED, GRADIENT, RING, CHECKER, XYZRGB, TEXTURE, CUBEMAP };
enum { SPHERICAL, PLANAR, CYLINDRICAL };
enum { UV_CHECKER, UV_ALIGN, UV_IMAGE };

// The scene's pattern tables (core/types.py Scene), contiguous.
struct Tables {
  const int* pat_kind;     // [n_pat]
  const float* pat_a;      // [n_pat, 3]
  const float* pat_b;      // [n_pat, 3]
  const float* pat_inv;    // [n_pat, 4, 4]
  const int* pat_map;      // [n_pat]
  const int* pat_uv;       // [n_pat, 6]
  const int* uv_kind;      // [n_uv]
  const float* uv_wh;      // [n_uv, 2]
  const float* uv_colors;  // [n_uv, 5, 3]
  const int* uv_image;     // [n_uv]
  const int* image_wh;     // [n_img, 2] (width, height)
  const float* images;     // [n_img, img_h, img_w, 3]
  int n_pat, n_uv, n_img, img_h, img_w;
  float inv_2pi, inv_pi;   // f32 reciprocals of (f32) 2 pi and pi
};

struct Rgb {
  float r, g, b;
};

__device__ __forceinline__ Rgb load3(const float* p) {
  return Rgb{p[0], p[1], p[2]};
}

__device__ __forceinline__ int clamp_row(int i, int n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// torch.remainder (PyTorch's CUDA kernel)
__device__ __forceinline__ float remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) m += b;
  return m;
}

// torch.remainder(torch.floor(x), 2.0) == 0.0
__device__ __forceinline__ bool even(float x) {
  return remainder(x, 2.0f) == 0.0f;
}

// patterns._rust_rem(x, 2.0) / 2.0, as the card runs it: x / 2.0 and the
// last / 2.0 are products with 0.5
__device__ __forceinline__ float half_rem2(float x) {
  return (x - truncf(x * 0.5f) * 2.0f) * 0.5f;
}

// torch.clamp and torch.maximum keep a NaN
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// intersect.mat3_apply(m[:3, :3], x) + m[:3, 3] for a row-major 4x4 m: each
// output x0 m[i][0], then fma with x1 m[i][1], then with x2 m[i][2], then
// the translation added
__device__ __forceinline__ void transform_point(const float* m, float x0,
                                                float x1, float x2,
                                                float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* mi = m + 4 * i;
    out[i] = fmaf(x2, mi[2], fmaf(x1, mi[1], x0 * mi[0])) + mi[3];
  }
}

// patterns._uv_pattern_at for one point: uv checker, align check or image
__device__ Rgb uv_pattern(const Tables& t, int uv_id, float u, float v) {
  const int uid = clamp_row(uv_id, t.n_uv);
  const float* c = t.uv_colors + 15 * uid;   // main, ul, ur, bl, br
  const int kind = t.uv_kind[uid];
  if (kind == UV_ALIGN) {
    const float* pick = c;
    if (v > 0.8f && u < 0.2f) pick = c + 3;
    if (v > 0.8f && u > 0.8f) pick = c + 6;
    if (v < 0.2f && u < 0.2f) pick = c + 9;
    if (v < 0.2f && u > 0.8f) pick = c + 12;
    return load3(pick);
  }
  if (kind == UV_IMAGE) {
    // nearest texel, v flipped; the image's own size from its clamped
    // row, the texel clamped to the padded table's width and height
    const int img = t.uv_image[uid] < 0 ? 0 : t.uv_image[uid];
    const int wh = clamp_row(img, t.n_img);
    const float iw = (float)t.image_wh[2 * wh];
    const float ih = (float)t.image_wh[2 * wh + 1];
    const float vv = 1.0f - v;
    long long px = (long long)floorf(u * (iw - 1.0f) + 0.5f);
    long long py = (long long)floorf(vv * (ih - 1.0f) + 0.5f);
    px = px < 0 ? 0 : (px > t.img_w - 1 ? t.img_w - 1 : px);
    py = py < 0 ? 0 : (py > t.img_h - 1 ? t.img_h - 1 : py);
    const long long texels = (long long)t.n_img * t.img_h * t.img_w;
    long long texel = ((long long)img * t.img_h + py) * t.img_w + px;
    texel = texel > texels - 1 ? texels - 1 : texel;
    return load3(t.images + 3 * texel);
  }
  // UV_CHECKER, and any other kind
  const float w = t.uv_wh[2 * uid], h = t.uv_wh[2 * uid + 1];
  return load3(c + (even(floorf(u * w) + floorf(v * h)) ? 0 : 3));
}

// patterns._uv_map: spherical, planar or cylindrical (any other kind
// spherical)
__device__ void uv_map(const Tables& t, int mapping, float x, float y,
                       float z, float& u, float& v) {
  if (mapping == PLANAR) {
    u = remainder(x, 1.0f);
    v = remainder(z, 1.0f);
    return;
  }
  const float theta = atan2f(x, z);
  u = 1.0f - (theta * t.inv_2pi + 0.5f);
  if (mapping == CYLINDRICAL) {
    v = remainder(y, 1.0f);
    return;
  }
  const float radius = sqrtf(x * x + y * y + z * z);
  const float phi = acosf(clamp_nan(y / (radius == 0.0f ? 1.0f : radius),
                                    -1.0f, 1.0f));
  v = 1.0f - phi * t.inv_pi;
}

// patterns._cube_map_color: the face of the dominant coordinate (the
// reference's if-chain order), its uv, its uv pattern (pat_uv's slots:
// left, right, front, back, up, down)
__device__ Rgb cube_map(const Tables& t, int pid, float x, float y, float z) {
  const float coord = max_nan(max_nan(fabsf(x), fabsf(y)), fabsf(z));
  int face;
  float u, v;
  if (coord == x) {
    face = 1;
    u = half_rem2(1.0f - z);
    v = half_rem2(y + 1.0f);
  } else if (coord == -x) {
    face = 0;
    u = half_rem2(z + 1.0f);
    v = half_rem2(y + 1.0f);
  } else if (coord == y) {
    face = 4;
    u = half_rem2(x + 1.0f);
    v = half_rem2(1.0f - z);
  } else if (coord == -y) {
    face = 5;
    u = half_rem2(x + 1.0f);
    v = half_rem2(z + 1.0f);
  } else if (coord == z) {
    face = 2;
    u = half_rem2(x + 1.0f);
    v = half_rem2(y + 1.0f);
  } else {
    face = 3;
    u = half_rem2(1.0f - x);
    v = half_rem2(y + 1.0f);
  }
  return uv_pattern(t, t.pat_uv[6 * pid + face], u, v);
}

// patterns.pattern_color for one point p in pattern space
__device__ Rgb pattern_at(const Tables& t, int pid, const float p[3]) {
  const float x = p[0], y = p[1], z = p[2];
  const float* a = t.pat_a + 3 * pid;
  const float* b = t.pat_b + 3 * pid;
  switch (t.pat_kind[pid]) {
    case GRADIENT: {
      const float f = x - floorf(x);
      return Rgb{a[0] + (b[0] - a[0]) * f, a[1] + (b[1] - a[1]) * f,
                 a[2] + (b[2] - a[2]) * f};
    }
    case RING:
      return load3(even(floorf(sqrtf(x * x + z * z))) ? a : b);
    case CHECKER:
      return load3(even(floorf(x) + floorf(y) + floorf(z)) ? a : b);
    case XYZRGB:
      return Rgb{x, y, z};
    case TEXTURE: {
      float u, v;
      uv_map(t, t.pat_map[pid], x, y, z, u, v);
      return uv_pattern(t, t.pat_uv[6 * pid], u, v);
    }
    case CUBEMAP:
      return cube_map(t, pid, x, y, z);
    default:   // STRIPED, and any other kind
      return load3(even(floorf(x)) ? a : b);
  }
}

__global__ void __launch_bounds__(THREADS)
pattern_color_kernel(const float* __restrict__ over,
                     const float* __restrict__ rows, long long rows_stride,
                     int inv_col, int pid_col,
                     const float* __restrict__ mat, long long mat_stride,
                     float* __restrict__ out, long long n, Tables t) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= n) return;
  const float* row = rows + r * rows_stride;
  const int pid = (int)row[pid_col];
  Rgb c;
  if (pid < 0) {
    c = load3(mat + r * mat_stride);
  } else {
    const int prow = clamp_row(pid, t.n_pat);
    float obj[3], p[3];
    transform_point(row + inv_col, over[3 * r], over[3 * r + 1],
                    over[3 * r + 2], obj);
    transform_point(t.pat_inv + 16 * prow, obj[0], obj[1], obj[2], p);
    c = pattern_at(t, prow, p);
  }
  out[3 * r] = c.r;
  out[3 * r + 1] = c.g;
  out[3 * r + 2] = c.b;
}

}  // namespace

// out [n, 3] = the base colour of n shading points: over [n, 3] the points,
// rows the shading rows (row stride rows_stride floats; columns inv_col to
// inv_col + 15 the inverse transform, pid_col the pattern id, as
// core/types.py's SHADE_INV and SHADE_PAT_ID), mat [n, >= 3] the
// material rows (row stride mat_stride); the tables contiguous, each of at
// least one row. Returns the launch's CUDA error (0: launched).
extern "C" int pattern_color_launch(
    const float* over, const float* rows, long long rows_stride, int inv_col,
    int pid_col, const float* mat, long long mat_stride, float* out,
    long long n,
    const int* pat_kind, const float* pat_a, const float* pat_b,
    const float* pat_inv, const int* pat_map, const int* pat_uv,
    const int* uv_kind, const float* uv_wh, const float* uv_colors,
    const int* uv_image, const int* image_wh, const float* images, int n_pat,
    int n_uv, int n_img, int img_h, int img_w, float inv_2pi, float inv_pi,
    void* stream) {
  if (n <= 0) return 0;
  if (n_pat < 1 || n_uv < 1 || n_img < 1 || img_h < 1 || img_w < 1 ||
      (n + THREADS - 1) / THREADS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tables t{pat_kind, pat_a,    pat_b,     pat_inv, pat_map,
                 pat_uv,   uv_kind,  uv_wh,     uv_colors, uv_image,
                 image_wh, images,   n_pat,     n_uv,    n_img,
                 img_h,    img_w,    inv_2pi,   inv_pi};
  pattern_color_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      over, rows, rows_stride, inv_col, pid_col, mat, mat_stride, out, n, t);
  return static_cast<int>(cudaGetLastError());
}
