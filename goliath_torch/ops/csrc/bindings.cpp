// PyTorch bindings of the splat path's CUDA kernels (K1 compositor_fwd.cu,
// K2 compositor_bwd.cu, K3 and K4 cumsum.cu). Built together with them by torch.utils.cpp_extension.load
// in goliath_torch/ops/gsplat_cuda.py. Each binding checks its tensors,
// allocates the outputs, launches on the current stream of the tensors'
// device and raises with the CUDA error if the launch fails.

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

extern "C" long long goliath_cumsum_scratch_len(long long n);
extern "C" int goliath_cumsum_i32(const int32_t* in, int32_t* out,
                                  int32_t* scratch, long long n,
                                  cudaStream_t stream);
extern "C" int goliath_cumsum_cols_f32(const float* in, float* out,
                                       float* scratch, int n_cols,
                                       long long n, cudaStream_t stream);
extern "C" int goliath_compositor_bwd(
    const float* rows, int feat, int n_chan, const int32_t* tile_start,
    const int32_t* tile_end, const int32_t* tile_cnt, int n_tiles,
    const float* dL_dout, const float* dL_dT, const float* T_final,
    const float* out_img, int ntx, int tile_size, int img_h, int img_w,
    int chunk, float* pair_grads, cudaStream_t stream);
extern "C" int goliath_compositor_fwd(
    const float* rows, int feat, int n_chan, const int32_t* tile_start,
    const int32_t* tile_end, int n_tiles, int ntx, int tile_size, int img_h,
    int img_w, int chunk, int nchunks, float* out_img, float* out_T,
    int32_t* out_cnt, cudaStream_t stream);

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

// Inclusive prefix sum of a 1-D int32 tensor.
at::Tensor cumsum_i32(const at::Tensor& x) {
  check_input(x, at::kInt, 1, "x");
  const c10::cuda::CUDAGuard guard(x.device());
  const long long n = x.numel();
  at::Tensor out = at::empty_like(x);
  at::Tensor scratch = at::empty(
      {std::max(goliath_cumsum_scratch_len(n), 1LL)}, x.options());
  check_launch(goliath_cumsum_i32(x.data_ptr<int32_t>(),
                                  out.data_ptr<int32_t>(),
                                  scratch.data_ptr<int32_t>(), n,
                                  at::cuda::getCurrentCUDAStream().stream()),
               "cumsum_i32");
  return out;
}

// Inclusive prefix sums along dim 1 of a [F, M] float32 tensor.
at::Tensor cumsum_cols_f32(const at::Tensor& x) {
  check_input(x, at::kFloat, 2, "x");
  const c10::cuda::CUDAGuard guard(x.device());
  const int64_t n_cols = x.size(0);
  const long long n = x.size(1);
  at::Tensor out = at::empty_like(x);
  at::Tensor scratch = at::empty(
      {std::max(n_cols * goliath_cumsum_scratch_len(n), 1LL)}, x.options());
  check_launch(goliath_cumsum_cols_f32(
                   x.data_ptr<float>(), out.data_ptr<float>(),
                   scratch.data_ptr<float>(), static_cast<int>(n_cols), n,
                   at::cuda::getCurrentCUDAStream().stream()),
               "cumsum_cols_f32");
  return out;
}

// rows [R, 8 + C] f32; tile_start/tile_end [ntx * nty] i32 with
// 0 <= start <= end <= R. Returns (color [C, H, W], T [H, W], cnt [tiles]).
std::vector<at::Tensor> compositor_fwd(const at::Tensor& rows,
                                       const at::Tensor& tile_start,
                                       const at::Tensor& tile_end,
                                       int64_t ntx, int64_t tile_size,
                                       int64_t img_h, int64_t img_w,
                                       int64_t chunk, int64_t nchunks) {
  check_input(rows, at::kFloat, 2, "rows");
  check_input(tile_start, at::kInt, 1, "tile_start");
  check_input(tile_end, at::kInt, 1, "tile_end");
  TORCH_CHECK(tile_start.device() == rows.device() &&
                  tile_end.device() == rows.device(),
              "rows and tile bounds must share a device");
  const int64_t n_tiles = tile_start.numel();
  TORCH_CHECK(tile_end.numel() == n_tiles, "tile bounds differ in length");
  const int64_t feat = rows.size(1);
  const int64_t n_chan = feat - 8;
  const c10::cuda::CUDAGuard guard(rows.device());
  at::Tensor img = at::empty({n_chan, img_h, img_w}, rows.options());
  at::Tensor T = at::empty({img_h, img_w}, rows.options());
  at::Tensor cnt = at::empty({n_tiles}, tile_start.options());
  check_launch(
      goliath_compositor_fwd(
          rows.data_ptr<float>(), feat, n_chan,
          tile_start.data_ptr<int32_t>(), tile_end.data_ptr<int32_t>(),
          n_tiles, ntx, tile_size, img_h, img_w, chunk, nchunks,
          img.data_ptr<float>(), T.data_ptr<float>(), cnt.data_ptr<int32_t>(),
          at::cuda::getCurrentCUDAStream().stream()),
      "compositor_fwd");
  return {img, T, cnt};
}

// Per-pair gradients [n_pairs, 16] in sorted-pair order. rows, tile_start
// and tile_end as for compositor_fwd, with end <= n_pairs <= R; cnt, T_final
// [H, W] and out_img [C, H, W] are the forward's outputs; dL_dout [C, H, W]
// and dL_dT [H, W] the gradients of the loss with respect to them.
at::Tensor compositor_bwd(const at::Tensor& rows, const at::Tensor& tile_start,
                          const at::Tensor& tile_end, const at::Tensor& cnt,
                          const at::Tensor& dL_dout, const at::Tensor& dL_dT,
                          const at::Tensor& T_final, const at::Tensor& out_img,
                          int64_t ntx, int64_t tile_size, int64_t chunk,
                          int64_t n_pairs) {
  check_input(rows, at::kFloat, 2, "rows");
  check_input(tile_start, at::kInt, 1, "tile_start");
  check_input(tile_end, at::kInt, 1, "tile_end");
  check_input(cnt, at::kInt, 1, "cnt");
  check_input(dL_dout, at::kFloat, 3, "dL_dout");
  check_input(dL_dT, at::kFloat, 2, "dL_dT");
  check_input(T_final, at::kFloat, 2, "T_final");
  check_input(out_img, at::kFloat, 3, "out_img");
  for (const at::Tensor* t : {&tile_start, &tile_end, &cnt, &dL_dout, &dL_dT,
                              &T_final, &out_img})
    TORCH_CHECK(t->device() == rows.device(),
                "all tensors must share a device");
  const int64_t n_tiles = tile_start.numel();
  TORCH_CHECK(tile_end.numel() == n_tiles && cnt.numel() == n_tiles,
              "tile bounds and cnt differ in length");
  const int64_t feat = rows.size(1);
  const int64_t n_chan = feat - 8;
  const int64_t img_h = T_final.size(0), img_w = T_final.size(1);
  TORCH_CHECK(dL_dT.sizes() == T_final.sizes() &&
                  dL_dout.sizes() == out_img.sizes() &&
                  out_img.size(0) == n_chan && out_img.size(1) == img_h &&
                  out_img.size(2) == img_w,
              "image planes must be [C, H, W] and [H, W] with C = ", n_chan);
  TORCH_CHECK(n_pairs >= 0 && n_pairs <= rows.size(0),
              "n_pairs must lie in [0, rows]");
  const c10::cuda::CUDAGuard guard(rows.device());
  at::Tensor grads = at::zeros({n_pairs, 16}, rows.options());
  check_launch(
      goliath_compositor_bwd(
          rows.data_ptr<float>(), feat, n_chan,
          tile_start.data_ptr<int32_t>(), tile_end.data_ptr<int32_t>(),
          cnt.data_ptr<int32_t>(), n_tiles, dL_dout.data_ptr<float>(),
          dL_dT.data_ptr<float>(), T_final.data_ptr<float>(),
          out_img.data_ptr<float>(), ntx, tile_size, img_h, img_w, chunk,
          grads.data_ptr<float>(), at::cuda::getCurrentCUDAStream().stream()),
      "compositor_bwd");
  return grads;
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("cumsum_cols_f32", &cumsum_cols_f32,
        "K3: inclusive float32 prefix sums along dim 1 of [F, M]");
  m.def("compositor_bwd", &compositor_bwd,
        "K2: tile compositor backward, per-pair gradients");
  m.def("cumsum_i32", &cumsum_i32, "K4: inclusive int32 prefix sum");
  m.def("compositor_fwd", &compositor_fwd, "K1: tile compositor forward");
}
