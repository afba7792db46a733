// PyTorch bindings of the port's CUDA kernels (K1, K6's forward and P1
// compositor_fwd.cu, K2 and K6's backward compositor_bwd.cu, K3, K4 and K7
// cumsum.cu, K5 zbuffer.cu, K8 mvp_march.cu, K10 mvp_march_bwd.cu, K9
// mvp_shadow.cu). Built together
// with them by torch.utils.cpp_extension.load in
// goliath_torch/ops/gsplat_cuda.py. Each binding checks its tensors,
// allocates the outputs, launches on the current stream of the tensors'
// device and raises with the CUDA error if the launch fails.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

extern "C" long long goliath_cumsum_i32_scratch_len(long long n);
extern "C" long long goliath_cumsum_f32_scratch_len(int n_cols, long long n);
extern "C" long long goliath_cumsum_rows_scratch_len(int n_cols, long long n);
extern "C" int goliath_cumsum_rows_tile_rows(int n_cols);
extern "C" int goliath_cumsum_i32(const int32_t* in, int32_t* out,
                                  unsigned long long* scratch, long long n,
                                  cudaStream_t stream);
extern "C" int goliath_cumsum_cols_f32(const float* in, float* out,
                                       unsigned long long* scratch,
                                       int n_cols, long long n,
                                       cudaStream_t stream);
extern "C" int goliath_cumsum_rows_f32(const float* in, float* out,
                                       unsigned long long* scratch,
                                       int n_cols, long long n,
                                       cudaStream_t stream);
extern "C" int goliath_compositor_bwd(
    const float* rows, int feat, int n_chan, const int32_t* tile_start,
    const int32_t* tile_end, const int32_t* tile_cnt, int tiles_per_img,
    int n_imgs, const float* dL_dout, const float* dL_dT,
    const float* T_final, int ntx, int tile_size, int img_h, int img_w,
    int chunk, int window, float* pair_grads, cudaStream_t stream);
extern "C" int goliath_compositor_fwd(
    const float* rows, int feat, int n_chan, const int32_t* tile_start,
    const int32_t* tile_end, const int32_t* replay_cnt, int tiles_per_img,
    int n_imgs, int ntx, int tile_size, int img_h, int img_w, int chunk,
    int nchunks, int window, int variant, float* out_img, float* out_T,
    int32_t* out_cnt, cudaStream_t stream);
extern "C" int goliath_zbuffer(const float* rows, const int32_t* sorted_prim,
                               const int32_t* tile_start,
                               const int32_t* tile_end, int n_tiles, int ntx,
                               int tile_size, int img_h, int img_w, int chunk,
                               int nchunks, int32_t* index_img, float* z_img,
                               cudaStream_t stream);

extern "C" int goliath_mvp_march(
    const float* raypos, const float* raydir, const float* tminmax,
    const int32_t* tile_start, const int32_t* tile_end,
    const int32_t* sorted_prim, const float* prims, const float* rows,
    const float* wrows, int n_tiles, int tile_size, int ntx, int img_h,
    int img_w, int tD, int tH, int tW, int wD, int wH, int wW, int S, int Sp,
    int M, int R, int fadeexp, float stepsize, float cap_off, float fadescale,
    int count, float* out, unsigned long long* counts, int32_t* cut,
    cudaStream_t stream);
extern "C" int goliath_mvp_march_bwd(
    const float* raypos, const float* raydir, const float* tminmax,
    const int32_t* tile_start, const int32_t* tile_end,
    const int32_t* sorted_prim, const float* prims, const float* rows,
    const float* wrows, const float* grad_out, int n_tiles, int tile_size,
    int tD, int tH, int tW, int wD, int wH, int wW, int S, int Sp, int M,
    int R, int fadeexp, float stepsize, float fadescale, int prim_grad,
    float* d_rows, float* d_wrows, float* d_prims, cudaStream_t stream);
extern "C" int goliath_shadow_integral(const float* density, int D, int H,
                                       int W, const float* points,
                                       long long n, const float* light,
                                       int n_steps, float* out,
                                       cudaStream_t stream);

static void check_launch(int err, const char* name) {
  TORCH_CHECK(err == 0, name, " failed to launch: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

static void check_input(const at::Tensor& t, at::ScalarType dtype, int dim,
                        const char* what) {
  TORCH_CHECK(t.is_cuda(), what, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == dtype && t.dim() == dim && t.is_contiguous(),
              what, " must be a contiguous ", dim, "-D ", dtype, " tensor");
}

// Inclusive prefix sum of a 1-D int32 tensor: one memset of the flag
// words, then one kernel. The scratch comes from PyTorch's caching
// allocator on the current stream, so each call has its own.
at::Tensor cumsum_i32(const at::Tensor& x) {
  check_input(x, at::kInt, 1, "x");
  const c10::cuda::CUDAGuard guard(x.device());
  const long long n = x.numel();
  at::Tensor out = at::empty_like(x);
  if (n == 0) return out;
  at::Tensor scratch = at::empty({goliath_cumsum_i32_scratch_len(n)},
                                 x.options().dtype(at::kLong));
  check_launch(goliath_cumsum_i32(
                   x.data_ptr<int32_t>(), out.data_ptr<int32_t>(),
                   reinterpret_cast<unsigned long long*>(
                       scratch.data_ptr<int64_t>()),
                   n, at::cuda::getCurrentCUDAStream().stream()),
               "cumsum_i32");
  return out;
}

// Inclusive prefix sums along dim 1 of a [F, M] float32 tensor: one memset
// of the flag words, then one kernel. The scratch comes from PyTorch's
// caching allocator on the current stream, so each call has its own.
at::Tensor cumsum_cols_f32(const at::Tensor& x) {
  check_input(x, at::kFloat, 2, "x");
  const c10::cuda::CUDAGuard guard(x.device());
  TORCH_CHECK(x.size(0) <= INT32_MAX, "too many columns");
  const int n_cols = static_cast<int>(x.size(0));
  const long long n = x.size(1);
  at::Tensor out = at::empty_like(x);
  if (n_cols == 0 || n == 0) return out;
  at::Tensor scratch =
      at::empty({goliath_cumsum_f32_scratch_len(n_cols, n)},
                x.options().dtype(at::kLong));
  check_launch(goliath_cumsum_cols_f32(
                   x.data_ptr<float>(), out.data_ptr<float>(),
                   reinterpret_cast<unsigned long long*>(
                       scratch.data_ptr<int64_t>()),
                   n_cols, n, at::cuda::getCurrentCUDAStream().stream()),
               "cumsum_cols_f32");
  return out;
}

// Inclusive prefix sums along dim 0 of a [M, F] float32 tensor: one memset
// of the flag words, then one kernel, as cumsum_cols_f32.
at::Tensor cumsum_rows_f32(const at::Tensor& x) {
  check_input(x, at::kFloat, 2, "x");
  const c10::cuda::CUDAGuard guard(x.device());
  TORCH_CHECK(x.size(1) <= INT32_MAX, "too many columns");
  const long long n = x.size(0);
  const int n_cols = static_cast<int>(x.size(1));
  at::Tensor out = at::empty_like(x);
  if (n_cols == 0 || n == 0) return out;
  at::Tensor scratch =
      at::empty({goliath_cumsum_rows_scratch_len(n_cols, n)},
                x.options().dtype(at::kLong));
  check_launch(goliath_cumsum_rows_f32(
                   x.data_ptr<float>(), out.data_ptr<float>(),
                   reinterpret_cast<unsigned long long*>(
                       scratch.data_ptr<int64_t>()),
                   n_cols, n, at::cuda::getCurrentCUDAStream().stream()),
               "cumsum_rows_f32");
  return out;
}

// The rows of one K7 tile at n_cols columns (its tests' edge sizes).
int64_t cumsum_rows_tile_rows(int64_t n_cols) {
  TORCH_CHECK(n_cols >= 1 && n_cols <= INT32_MAX, "n_cols out of range");
  return goliath_cumsum_rows_tile_rows(static_cast<int>(n_cols));
}

// rows [R, 8 + C] f32; tile_start/tile_end [n_imgs * ntx * nty] i32 with
// 0 <= start <= end <= R; replay_cnt empty, or [n_imgs * ntx * nty] i32
// blocks to walk (P1). window 0 (Pallas) or 1 (XLA), variant 0..3 (full,
// noexp, nochain, loadonly). Returns (color [n_imgs, C, H, W],
// T [n_imgs, H, W], cnt [n_imgs * tiles]).
std::vector<at::Tensor> compositor_fwd(
    const at::Tensor& rows, const at::Tensor& tile_start,
    const at::Tensor& tile_end, const at::Tensor& replay_cnt, int64_t ntx,
    int64_t tile_size, int64_t img_h, int64_t img_w, int64_t chunk,
    int64_t nchunks, int64_t n_imgs, int64_t window, int64_t variant) {
  check_input(rows, at::kFloat, 2, "rows");
  check_input(tile_start, at::kInt, 1, "tile_start");
  check_input(tile_end, at::kInt, 1, "tile_end");
  TORCH_CHECK(tile_start.device() == rows.device() &&
                  tile_end.device() == rows.device(),
              "rows and tile bounds must share a device");
  const int64_t n_tiles = tile_start.numel();
  TORCH_CHECK(tile_end.numel() == n_tiles, "tile bounds differ in length");
  TORCH_CHECK(n_imgs >= 1 && n_tiles % n_imgs == 0,
              "the tile bounds must hold n_imgs images' tiles");
  const bool replay = replay_cnt.numel() > 0;
  if (replay) {
    check_input(replay_cnt, at::kInt, 1, "replay_cnt");
    TORCH_CHECK(replay_cnt.numel() == n_tiles &&
                    replay_cnt.device() == rows.device(),
                "replay_cnt must hold one count per tile on rows' device");
  }
  const int64_t feat = rows.size(1);
  const int64_t n_chan = feat - 8;
  const c10::cuda::CUDAGuard guard(rows.device());
  at::Tensor img = at::empty({n_imgs, n_chan, img_h, img_w}, rows.options());
  at::Tensor T = at::empty({n_imgs, img_h, img_w}, rows.options());
  at::Tensor cnt = at::empty({n_tiles}, tile_start.options());
  check_launch(
      goliath_compositor_fwd(
          rows.data_ptr<float>(), feat, n_chan,
          tile_start.data_ptr<int32_t>(), tile_end.data_ptr<int32_t>(),
          replay ? replay_cnt.data_ptr<int32_t>() : nullptr,
          n_tiles / n_imgs, n_imgs, ntx, tile_size, img_h, img_w, chunk,
          nchunks, window, variant, img.data_ptr<float>(), T.data_ptr<float>(),
          cnt.data_ptr<int32_t>(), at::cuda::getCurrentCUDAStream().stream()),
      "compositor_fwd");
  return {img, T, cnt};
}

// Per-pair gradients [n_pairs, 16] in (global) sorted-pair order. rows,
// tile_start and tile_end as for compositor_fwd, with end <= n_pairs <= R;
// cnt and T_final [n_imgs, H, W] are the forward's outputs; dL_dout
// [n_imgs, C, H, W] and dL_dT [n_imgs, H, W] the gradients of the loss with
// respect to its color and T. window as for compositor_fwd.
at::Tensor compositor_bwd(const at::Tensor& rows, const at::Tensor& tile_start,
                          const at::Tensor& tile_end, const at::Tensor& cnt,
                          const at::Tensor& dL_dout, const at::Tensor& dL_dT,
                          const at::Tensor& T_final, int64_t ntx, int64_t tile_size, int64_t chunk,
                          int64_t n_pairs, int64_t window) {
  check_input(rows, at::kFloat, 2, "rows");
  check_input(tile_start, at::kInt, 1, "tile_start");
  check_input(tile_end, at::kInt, 1, "tile_end");
  check_input(cnt, at::kInt, 1, "cnt");
  check_input(dL_dout, at::kFloat, 4, "dL_dout");
  check_input(dL_dT, at::kFloat, 3, "dL_dT");
  check_input(T_final, at::kFloat, 3, "T_final");
  for (const at::Tensor* t : {&tile_start, &tile_end, &cnt, &dL_dout, &dL_dT,
                              &T_final})
    TORCH_CHECK(t->device() == rows.device(),
                "all tensors must share a device");
  const int64_t n_tiles = tile_start.numel();
  TORCH_CHECK(tile_end.numel() == n_tiles && cnt.numel() == n_tiles,
              "tile bounds and cnt differ in length");
  const int64_t feat = rows.size(1);
  const int64_t n_chan = feat - 8;
  const int64_t n_imgs = T_final.size(0);
  const int64_t img_h = T_final.size(1), img_w = T_final.size(2);
  TORCH_CHECK(dL_dT.sizes() == T_final.sizes() &&
                  dL_dout.size(0) == n_imgs && dL_dout.size(1) == n_chan &&
                  dL_dout.size(2) == img_h && dL_dout.size(3) == img_w,
              "image planes must be [B, C, H, W] and [B, H, W] with C = ",
              n_chan);
  TORCH_CHECK(n_imgs >= 1 && n_tiles % n_imgs == 0,
              "the tile bounds must hold n_imgs images' tiles");
  TORCH_CHECK(n_pairs >= 0 && n_pairs <= rows.size(0),
              "n_pairs must lie in [0, rows]");
  const c10::cuda::CUDAGuard guard(rows.device());
  at::Tensor grads = at::zeros({n_pairs, 16}, rows.options());
  check_launch(
      goliath_compositor_bwd(
          rows.data_ptr<float>(), feat, n_chan,
          tile_start.data_ptr<int32_t>(), tile_end.data_ptr<int32_t>(),
          cnt.data_ptr<int32_t>(), n_tiles / n_imgs, n_imgs,
          dL_dout.data_ptr<float>(), dL_dT.data_ptr<float>(),
          T_final.data_ptr<float>(), ntx, tile_size, img_h, img_w, chunk,
          window, grads.data_ptr<float>(),
          at::cuda::getCurrentCUDAStream().stream()),
      "compositor_bwd");
  return grads;
}

// rows [R, 16] f32 face rows and sorted_prim [R] i32 in sorted-pair order;
// tile_start/tile_end [ntx * nty] i32 with 0 <= start <= end <= R. Returns
// (face index [H, W] i32, -1 where empty; depth [H, W] f32).
std::vector<at::Tensor> zbuffer(const at::Tensor& rows,
                                const at::Tensor& sorted_prim,
                                const at::Tensor& tile_start,
                                const at::Tensor& tile_end, int64_t ntx,
                                int64_t tile_size, int64_t img_h,
                                int64_t img_w, int64_t chunk,
                                int64_t nchunks) {
  check_input(rows, at::kFloat, 2, "rows");
  check_input(sorted_prim, at::kInt, 1, "sorted_prim");
  check_input(tile_start, at::kInt, 1, "tile_start");
  check_input(tile_end, at::kInt, 1, "tile_end");
  for (const at::Tensor* t : {&sorted_prim, &tile_start, &tile_end})
    TORCH_CHECK(t->device() == rows.device(),
                "all tensors must share a device");
  TORCH_CHECK(rows.size(1) == 16, "rows must be [R, 16]");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(rows.data_ptr()) % 16 == 0,
              "rows must start on a 16-byte boundary");
  TORCH_CHECK(sorted_prim.numel() == rows.size(0),
              "sorted_prim must have one entry per row");
  const int64_t n_tiles = tile_start.numel();
  TORCH_CHECK(tile_end.numel() == n_tiles, "tile bounds differ in length");
  const c10::cuda::CUDAGuard guard(rows.device());
  at::Tensor index_img = at::empty({img_h, img_w}, tile_start.options());
  at::Tensor z_img = at::empty({img_h, img_w}, rows.options());
  check_launch(
      goliath_zbuffer(rows.data_ptr<float>(), sorted_prim.data_ptr<int32_t>(),
                      tile_start.data_ptr<int32_t>(),
                      tile_end.data_ptr<int32_t>(), n_tiles, ntx, tile_size,
                      img_h, img_w, chunk, nchunks,
                      index_img.data_ptr<int32_t>(), z_img.data_ptr<float>(),
                      at::cuda::getCurrentCUDAStream().stream()),
      "zbuffer");
  return {index_img, z_img};
}

// The march's inputs, as K8 and K10 take them (shapes: mvp_march).
static void check_march_inputs(
    const at::Tensor& raypos, const at::Tensor& raydir,
    const at::Tensor& tminmax, const at::Tensor& tile_start,
    const at::Tensor& tile_end, const at::Tensor& sorted_prim,
    const at::Tensor& prims, const at::Tensor& rows, const at::Tensor& wrows,
    int64_t tile_size, const std::vector<int64_t>& tshape,
    const std::vector<int64_t>& wshape, int64_t S, int64_t Sp, int64_t M,
    int64_t R, int64_t fadeexp) {
  check_input(raypos, at::kFloat, 3, "raypos");
  check_input(raydir, at::kFloat, 3, "raydir");
  check_input(tminmax, at::kFloat, 3, "tminmax");
  check_input(tile_start, at::kInt, 1, "tile_start");
  check_input(tile_end, at::kInt, 1, "tile_end");
  check_input(sorted_prim, at::kInt, 1, "sorted_prim");
  check_input(prims, at::kFloat, 2, "prims");
  check_input(rows, at::kFloat, 2, "rows");
  const bool has_warp = wrows.numel() > 0;
  if (has_warp) check_input(wrows, at::kFloat, 2, "wrows");
  for (const at::Tensor* t : {&raydir, &tminmax, &tile_start, &tile_end,
                              &sorted_prim, &prims, &rows})
    TORCH_CHECK(t->device() == raypos.device(),
                "all tensors must share a device");
  TORCH_CHECK(!has_warp || wrows.device() == raypos.device(),
              "all tensors must share a device");
  const int64_t T = raypos.size(0), P = raypos.size(1);
  const int64_t K = prims.size(0);
  TORCH_CHECK(tile_size >= 1 && P == tile_size * tile_size &&
                  raypos.size(2) == 3 && raydir.sizes() == raypos.sizes() &&
                  tminmax.size(0) == T && tminmax.size(1) == P &&
                  tminmax.size(2) == 2,
              "rays must be [T, tile_size^2, 3] and tminmax [T, P, 2]");
  TORCH_CHECK(tile_start.numel() == T && tile_end.numel() == T,
              "tile bounds must be [T]");
  TORCH_CHECK(prims.size(1) == 24, "prims must be [K, 24]");
  TORCH_CHECK(tshape.size() == 3 && rows.size(1) == 8 &&
                  rows.size(0) == K * tshape[0] * tshape[1] * tshape[2],
              "rows must be [K * D * H * W, 8] (the packed RGBA template)");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(rows.data_ptr()) % 16 == 0,
              "rows must start on a 16-byte boundary");
  TORCH_CHECK(wshape.size() == 3, "wshape must hold (D, H, W)");
  TORCH_CHECK(!has_warp || (wrows.size(1) == 6 &&
                            wrows.size(0) ==
                                K * wshape[0] * wshape[1] * wshape[2]),
              "wrows must be [K * D * H * W, 6] (the packed warp field)");
  TORCH_CHECK(S >= 1 && Sp >= 1 && Sp <= S && M >= 1 && R >= 1 && R <= M &&
                  fadeexp >= 1,
              "the march takes 1 <= window_steps <= max_steps, 1 <= R <= M "
              "and an integer fadeexp >= 1");
  for (int64_t v : {T, P, K, S, M, R, fadeexp, K * tshape[0]})
    TORCH_CHECK(v <= INT32_MAX, "a size is out of range");
}

// K8. raypos/raydir [T, P, 3] and tminmax [T, P, 2] f32 (P = tile_size^2,
// T = ntx * nty); tile_start/tile_end [T] i32 into sorted_prim [budget] i32;
// prims [K, 24] f32; rows [K*tD*tH*tW, 8] f32; wrows empty or
// [K*wD*wH*wW, 6] f32. Returns (rgba [T, 4, P] f32, counts [4] i64: taps,
// rays_over_r, rays_step_capped, window_cut_pairs; cut [K] i32, 1 for a
// prim whose window was cut), the counts and flags 0 unless count.
std::vector<at::Tensor> mvp_march(
    const at::Tensor& raypos, const at::Tensor& raydir,
    const at::Tensor& tminmax, const at::Tensor& tile_start,
    const at::Tensor& tile_end, const at::Tensor& sorted_prim,
    const at::Tensor& prims, const at::Tensor& rows, const at::Tensor& wrows,
    int64_t tile_size, int64_t ntx, int64_t img_h, int64_t img_w,
    std::vector<int64_t> tshape, std::vector<int64_t> wshape, int64_t S,
    int64_t Sp, int64_t M, int64_t R, int64_t fadeexp, double stepsize,
    double cap_off, double fadescale, bool count) {
  check_march_inputs(raypos, raydir, tminmax, tile_start, tile_end,
                     sorted_prim, prims, rows, wrows, tile_size, tshape,
                     wshape, S, Sp, M, R, fadeexp);
  const bool has_warp = wrows.numel() > 0;
  const int64_t T = raypos.size(0), P = raypos.size(1);
  const int64_t K = prims.size(0);
  TORCH_CHECK(ntx >= 1 && T % ntx == 0, "T must be a multiple of ntx");
  for (int64_t v : {img_h, img_w})
    TORCH_CHECK(v <= INT32_MAX, "a size is out of range");
  const c10::cuda::CUDAGuard guard(raypos.device());
  at::Tensor out = at::empty({T, 4, P}, raypos.options());
  at::Tensor counts = at::zeros({4}, raypos.options().dtype(at::kLong));
  at::Tensor cut = at::zeros({K}, tile_start.options());
  check_launch(
      goliath_mvp_march(
          raypos.data_ptr<float>(), raydir.data_ptr<float>(),
          tminmax.data_ptr<float>(), tile_start.data_ptr<int32_t>(),
          tile_end.data_ptr<int32_t>(), sorted_prim.data_ptr<int32_t>(),
          prims.data_ptr<float>(), rows.data_ptr<float>(),
          has_warp ? wrows.data_ptr<float>() : nullptr, T, tile_size, ntx,
          img_h, img_w, tshape[0], tshape[1], tshape[2], wshape[0],
          wshape[1], wshape[2], S, Sp, M, R, fadeexp, (float)stepsize,
          (float)cap_off, (float)fadescale, count ? 1 : 0,
          out.data_ptr<float>(),
          reinterpret_cast<unsigned long long*>(counts.data_ptr<int64_t>()),
          cut.data_ptr<int32_t>(), at::cuda::getCurrentCUDAStream().stream()),
      "mvp_march");
  return {out, counts, cut};
}

// K10. K8's inputs (as mvp_march) and grad_out [T, 4, P] f32, the gradient
// of K8's rgba. Returns (d_rows [K*tD*tH*tW, 8], d_wrows [K*wD*wH*wW, 6]
// or empty without a warp, d_prims [K, 15]: d primpos 3, d primrot 9
// row-major, d primscale 3), f32, zeroed here and added into by the
// kernel; d_prims stays 0 unless prim_grad.
std::vector<at::Tensor> mvp_march_bwd(
    const at::Tensor& raypos, const at::Tensor& raydir,
    const at::Tensor& tminmax, const at::Tensor& tile_start,
    const at::Tensor& tile_end, const at::Tensor& sorted_prim,
    const at::Tensor& prims, const at::Tensor& rows, const at::Tensor& wrows,
    const at::Tensor& grad_out, int64_t tile_size,
    std::vector<int64_t> tshape, std::vector<int64_t> wshape, int64_t S,
    int64_t Sp, int64_t M, int64_t R, int64_t fadeexp, double stepsize,
    double fadescale, bool prim_grad) {
  check_march_inputs(raypos, raydir, tminmax, tile_start, tile_end,
                     sorted_prim, prims, rows, wrows, tile_size, tshape,
                     wshape, S, Sp, M, R, fadeexp);
  check_input(grad_out, at::kFloat, 3, "grad_out");
  const int64_t T = raypos.size(0), P = raypos.size(1);
  const int64_t K = prims.size(0);
  TORCH_CHECK(grad_out.device() == raypos.device() &&
                  grad_out.size(0) == T && grad_out.size(1) == 4 &&
                  grad_out.size(2) == P,
              "grad_out must be [T, 4, P] on the rays' device");
  const bool has_warp = wrows.numel() > 0;
  const c10::cuda::CUDAGuard guard(raypos.device());
  at::Tensor d_rows = at::zeros_like(rows);
  at::Tensor d_wrows = has_warp ? at::zeros_like(wrows)
                                : at::empty({0}, rows.options());
  at::Tensor d_prims = at::zeros({K, 15}, rows.options());
  check_launch(
      goliath_mvp_march_bwd(
          raypos.data_ptr<float>(), raydir.data_ptr<float>(),
          tminmax.data_ptr<float>(), tile_start.data_ptr<int32_t>(),
          tile_end.data_ptr<int32_t>(), sorted_prim.data_ptr<int32_t>(),
          prims.data_ptr<float>(), rows.data_ptr<float>(),
          has_warp ? wrows.data_ptr<float>() : nullptr,
          grad_out.data_ptr<float>(), T, tile_size, tshape[0], tshape[1],
          tshape[2], wshape[0], wshape[1], wshape[2], S, Sp, M, R, fadeexp,
          (float)stepsize, (float)fadescale, prim_grad ? 1 : 0,
          d_rows.data_ptr<float>(),
          has_warp ? d_wrows.data_ptr<float>() : nullptr,
          d_prims.data_ptr<float>(),
          at::cuda::getCurrentCUDAStream().stream()),
      "mvp_march_bwd");
  return {d_rows, d_wrows, d_prims};
}

// K9. density [D, H, W] f32, points [n, 3] f32, light_pos [3] f32, all on
// one device. Returns the accumulated alpha [n] f32.
at::Tensor shadow_integral(const at::Tensor& density, const at::Tensor& points,
                           const at::Tensor& light_pos, int64_t n_steps) {
  check_input(density, at::kFloat, 3, "density");
  check_input(points, at::kFloat, 2, "points");
  check_input(light_pos, at::kFloat, 1, "light_pos");
  TORCH_CHECK(points.size(1) == 3 && light_pos.numel() == 3,
              "points must be [n, 3] and light_pos [3]");
  TORCH_CHECK(points.device() == density.device() &&
                  light_pos.device() == density.device(),
              "all tensors must share a device");
  TORCH_CHECK(n_steps >= 1 && n_steps <= INT32_MAX,
              "n_steps must be at least 1");
  const c10::cuda::CUDAGuard guard(density.device());
  at::Tensor out = at::empty({points.size(0)}, points.options());
  check_launch(goliath_shadow_integral(
                   density.data_ptr<float>(), density.size(0),
                   density.size(1), density.size(2), points.data_ptr<float>(),
                   points.size(0), light_pos.data_ptr<float>(), n_steps,
                   out.data_ptr<float>(),
                   at::cuda::getCurrentCUDAStream().stream()),
               "shadow_integral");
  return out;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("cumsum_cols_f32", &cumsum_cols_f32,
        "K3: inclusive float32 prefix sums along dim 1 of [F, M]");
  m.def("compositor_bwd", &compositor_bwd,
        "K2: tile compositor backward, per-pair gradients");
  m.def("cumsum_rows_f32", &cumsum_rows_f32,
        "K7: inclusive float32 prefix sums along dim 0 of [M, F]");
  m.def("cumsum_rows_tile_rows", &cumsum_rows_tile_rows,
        "K7: the rows of one tile at F columns");
  m.def("cumsum_i32", &cumsum_i32, "K4: inclusive int32 prefix sum");
  m.def("compositor_fwd", &compositor_fwd,
        "K1 (K6 with n_imgs > 1, P1 with a variant): tile compositor forward");
  m.def("zbuffer", &zbuffer, "K5: mesh z-buffer, nearest face per pixel");
  m.def("mvp_march", &mvp_march, "K8: the tiled MVP march's forward");
  m.def("mvp_march_bwd", &mvp_march_bwd,
        "K10: the tiled MVP march's backward (K8's)");
  m.def("shadow_integral", &shadow_integral,
        "K9: the deep-shadow integral from a light to each point");
}
