// The temporal frame's history stage (vri_tpu_torch/passes/frame.py:
// temporal_history_reference) as one kernel: one thread a GI pixel.
//
// The thread reprojects its point through the previous frame's camera,
// takes the four bilinear taps of the history (screen bounds, the
// velocity-widened depth tolerance, the normal test, a history of its
// own), blends its new indirect sample into the running mean (at most
// history_cap frames), writes its new (8,) history row [indirect | depth |
// normal | count] and then the gi_scale x gi_scale full-resolution pixels
// it covers: colour = emissive + albedo * (direct + blended indirect)
// where the G-buffer is valid, and the frame count.  Each full-resolution
// input is read once; the incoming history is only read.
//
// Every float operation is the plain version's, in its order, and the
// file is built with -fmad=false, so the outputs are bit-equal to it on
// the card:
// * the clip products are written out per column, ((p.x * vp[k][0] +
//   p.y * vp[k][1]) + p.z * vp[k][2]) + vp[k][3];
// * PyTorch divides a CUDA tensor by a host scalar as a product with the
//   scalar's float reciprocal, so the query's own row is
//   floor(i * (1 / width)) and its column fmod(i, width);
// * the plain version gathers the pair [data[r] | data[(r + 1) mod rows]]
//   at the clamped row r = clamp(y, 0, rows - 1) * width + clamp(x0, 0,
//   width - 2) and a tap reads slot x - that column; here the tap reads
//   the one history row its slot names, the last row pairing with the
//   first as the roll makes it;
// * every tap is multiplied by its weight, zero weights included, and the
//   sums start from 0 and run over the taps in the order (row 0: x0,
//   x0 + 1; row 1: x0, x0 + 1), so a non-finite history row propagates
//   as it does in the plain version;
// * torch.clamp keeps a NaN; a float -> int32 conversion saturates (NaN
//   -> 0), as PyTorch's does on the card; int32 sums wrap.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const float* data;        // (data_rows, 8) history, read only
  long long data_rows;      // (rows + 2 * halo) * width
  const float* view_proj;   // (4, 4) of the frame that wrote the history
  const float* eye;         // (3,) of that frame
  const float* position;    // (n, 3) GI-resolution queries
  const float* normal;      // (n, 3)
  const bool* valid;        // (n,)
  const float* ind;         // (n, 3) this frame's indirect sample
  const float* depth;       // (n,) the G-buffer depth (gi_scale 1)
  const float* new_eye;     // (3,) this frame's eye (gi_scale > 1)
  const float* emissive;    // (H * W, 3) full resolution
  const float* albedo;      // (H * W, 3)
  const float* direct;      // (H * W, 3)
  const bool* full_valid;   // (H * W,)
  int n;                    // GI pixels
  int width;                // GI-resolution width
  int rows;                 // history rows, halo rows included
  int scale;                // gi_scale
  int y0;                   // the history's first row in the frame
  int proj_height;          // the projected frame's rows
  int halo;                 // ghost rows above and below the history
  float depth_tol;
  float history_cap;
  float* out_data;          // (n, 8) the new history
  float* color;             // (H * W, 3)
  float* gi_history;        // (H * W,)
};

// torch.clamp(x, min=lo) / torch.clamp(x, max=hi): NaN stays
__device__ __forceinline__ float t_clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float t_clamp_max(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}
// int32 addition as a tensor's: wraps
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__global__ void __launch_bounds__(kThreads)
temporal_history_kernel(const Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const float* vp = a.view_proj;
  const float p0 = a.position[3 * i], p1 = a.position[3 * i + 1],
              p2 = a.position[3 * i + 2];
  const float n0 = a.normal[3 * i], n1 = a.normal[3 * i + 1],
              n2 = a.normal[3 * i + 2];

  // clip = [position, 1] @ view_proj.T, one column product at a time
  const float c0 = ((p0 * vp[0] + p1 * vp[1]) + p2 * vp[2]) + vp[3];
  const float c1 = ((p0 * vp[4] + p1 * vp[5]) + p2 * vp[6]) + vp[7];
  const float w = ((p0 * vp[12] + p1 * vp[13]) + p2 * vp[14]) + vp[15];
  const float wc = t_clamp_min(w, 1e-6f);
  const float ndc0 = c0 / wc, ndc1 = c1 / wc;
  const float fw = (float)a.width;
  const float px = (ndc0 * 0.5f + 0.5f) * fw - 0.5f;
  const float py = ((0.5f - ndc1 * 0.5f) * (float)a.proj_height -
                    (float)a.y0) - 0.5f;
  const int x0 = (int)floorf(px);
  const int y0i = (int)floorf(py);
  const float fx = px - (float)x0;
  const float fy = py - (float)y0i;

  // velocity: the reprojected point against the query's own pixel
  const float ar = (float)i;
  const float own_x = fmodf(ar, fw);
  const float own_y = floorf(ar * (1.0f / fw));
  const float vx = px - own_x, vy = py - own_y;
  const float vel = sqrtf(vx * vx + vy * vy);
  const float tol = a.depth_tol * (1.0f + 0.25f * t_clamp_max(vel, 8.0f));

  const float e0 = p0 - a.eye[0], e1 = p1 - a.eye[1], e2 = p2 - a.eye[2];
  const float t_prev = sqrtf((e0 * e0 + e1 * e1) + e2 * e2);
  const int xw = min(max(x0, 0), max(a.width - 2, 0));
  const bool front = w > 1e-6f;

  float wsum = 0.0f, h0 = 0.0f, h1 = 0.0f, h2 = 0.0f, hc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int yi = wrap_add(y0i, dy + a.halo);
    const bool y_in = front && yi >= 0 && yi < a.rows;
    const long long r =
        (long long)min(max(yi, 0), a.rows - 1) * a.width + xw;
    const float wy = dy ? fy : 1.0f - fy;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int xi = wrap_add(x0, dx);
      const int si = wrap_add(xi, -xw);   // window slot, 0 or 1
      const bool inside = y_in && xi >= 0 && xi < a.width && si >= 0 &&
                          si <= 1;
      const long long row = si == 1 ? (r + 1 == a.data_rows ? 0 : r + 1) : r;
      const float4 lo = reinterpret_cast<const float4*>(a.data)[2 * row];
      const float4 hi = reinterpret_cast<const float4*>(a.data)[2 * row + 1];
      const bool depth_ok = fabsf(lo.w - t_prev) <= tol * t_prev + 1e-3f;
      const bool normal_ok = (hi.x * n0 + hi.y * n1) + hi.z * n2 > 0.5f;
      const bool ok = inside && depth_ok && normal_ok && hi.w > 0.0f;
      const float wgt = ok ? wy * (dx ? fx : 1.0f - fx) : 0.0f;
      wsum = wsum + wgt;
      h0 = h0 + lo.x * wgt;
      h1 = h1 + lo.y * wgt;
      h2 = h2 + lo.z * wgt;
      hc = hc + hi.w * wgt;
    }
  }
  const float scale = 1.0f / t_clamp_min(wsum, 1e-6f);
  const bool keep = a.valid[i] && wsum > 0.05f;
  h0 = keep ? h0 * scale : 0.0f;
  h1 = keep ? h1 * scale : 0.0f;
  h2 = keep ? h2 * scale : 0.0f;
  hc = keep ? hc * scale : 0.0f;

  // the running mean over at most history_cap frames
  const float count = t_clamp_max(hc, a.history_cap) + 1.0f;
  const float b0 = h0 + (a.ind[3 * i] - h0) / count;
  const float b1 = h1 + (a.ind[3 * i + 1] - h1) / count;
  const float b2 = h2 + (a.ind[3 * i + 2] - h2) / count;
  float t_s;
  if (a.scale > 1) {
    const float d0 = p0 - a.new_eye[0], d1 = p1 - a.new_eye[1],
                d2 = p2 - a.new_eye[2];
    t_s = sqrtf((d0 * d0 + d1 * d1) + d2 * d2);
  } else {
    t_s = a.depth[i];
  }
  float4* out = reinterpret_cast<float4*>(a.out_data) + 2 * (long long)i;
  out[0] = make_float4(b0, b1, b2, t_s);
  out[1] = make_float4(n0, n1, n2, count);

  // the full-resolution pixels this GI pixel covers
  const int s = a.scale;
  const int gy = i / a.width, gx = i - gy * a.width;
  const long long full_w = (long long)a.width * s;
  for (int dy = 0; dy < s; ++dy) {
    const long long q0 = ((long long)gy * s + dy) * full_w + (long long)gx * s;
    for (int dx = 0; dx < s; ++dx) {
      const long long q = q0 + dx;
      float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
      if (a.full_valid[q]) {
        r0 = a.emissive[3 * q] + a.albedo[3 * q] * (a.direct[3 * q] + b0);
        r1 = a.emissive[3 * q + 1] +
             a.albedo[3 * q + 1] * (a.direct[3 * q + 1] + b1);
        r2 = a.emissive[3 * q + 2] +
             a.albedo[3 * q + 2] * (a.direct[3 * q + 2] + b2);
      }
      a.color[3 * q] = r0;
      a.color[3 * q + 1] = r1;
      a.color[3 * q + 2] = r2;
      a.gi_history[q] = count;
    }
  }
}

}  // namespace

extern "C" int vri_temporal_history(
    const float* data, long long data_rows, const float* view_proj,
    const float* eye, const float* position, const float* normal,
    const bool* valid, const float* ind, const float* depth,
    const float* new_eye, const float* emissive, const float* albedo,
    const float* direct, const bool* full_valid, int n, int width, int rows,
    int scale, int y0, int proj_height, int halo,
    float depth_tol, float history_cap, float* out_data, float* color,
    float* gi_history, void* stream) {
  if (n <= 0) return 0;
  if (width < 1 || scale < 1 || rows < 1 ||
      data_rows != (long long)rows * width)
    return -1;
  const Args a{data, data_rows, view_proj, eye, position, normal, valid,
               ind, depth, new_eye, emissive, albedo, direct, full_valid, n,
               width, rows, scale, y0, proj_height, halo,
               depth_tol, history_cap, out_data, color, gi_history};
  temporal_history_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
