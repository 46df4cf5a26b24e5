// dspnet_tpu native data loader.
//
// Counterpart of the reference's host-side input machinery: the
// multithreaded C++ record iterator (mx.io.ImageDetRecordIter with
// preprocess_threads=48, reference config/config.py:56) plus the python
// cv2.warpAffine augmentation hot loop (dataset/iterator.py:476-603).
//
// Responsibilities (all on host CPU, overlapped with device compute through a
// bounded prefetch queue):
//   * JPEG (libjpeg) / PNG (libpng) decode
//   * one inverse-mapped affine warp per image: bilinear + constant border
//     for RGB, nearest for the segmentation mask (cv2.warpAffine semantics)
//   * box-corner transform, flip, clip, area/out-of-image filtering,
//     distance rescale by 1/sqrt(sx*sy) — the exact augmentation contract of
//     dataset/iterator.py:476-548
//   * mean-pixel subtraction, NHWC float32 output, 1/4-res nearest seg
//     downsample
//   * N worker threads filling a bounded batch queue (backpressure)
//
// Augmentation parameters and the epoch shuffle order are produced on the
// Python side (numpy seed 233) and handed over per epoch, so batches are
// bit-identical with the pure-Python iterator.
//
// C ABI only (consumed via ctypes).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

constexpr int kMaxObjects = 200;
constexpr int kLabelWidth = 6;

// ----------------------------------------------------------------- decode

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC, RGB for images, single channel for masks
};

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Read `len` bytes at `off` of `path` (len == 0: the whole file). Record
// stores (.drec, dspnet_tpu/data/record.py) hand spans of one big file to the
// workers — the sequential-IO benefit of the reference's .rec format
// (tools/im2rec.py:137-140) without recompression.
bool read_span(const std::string& path, uint64_t off, uint64_t len,
               std::vector<uint8_t>* buf) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  if (len == 0) {
    fseeko(f, 0, SEEK_END);
    len = ftello(f);
    off = 0;
  }
  if (fseeko(f, off, SEEK_SET) != 0) {
    fclose(f);
    return false;
  }
  buf->resize(len);
  size_t got = fread(buf->data(), 1, len, f);
  fclose(f);
  return got == len;
}

bool decode_jpeg_mem(const uint8_t* bytes, size_t len, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(bytes), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = 3;
  out->data.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_jpeg(const std::string& path, uint64_t off, uint64_t len, Image* out) {
  std::vector<uint8_t> buf;
  if (!read_span(path, off, len, &buf)) return false;
  return decode_jpeg_mem(buf.data(), buf.size(), out);
}

struct PngMem {
  const uint8_t* p;
  size_t n, pos;
};

void png_mem_read(png_structp png, png_bytep dst, png_size_t n) {
  PngMem* m = reinterpret_cast<PngMem*>(png_get_io_ptr(png));
  if (m->pos + n > m->n) png_error(png, "png: read past end of buffer");
  std::memcpy(dst, m->p + m->pos, n);
  m->pos += n;
}

bool decode_png_gray_mem(const uint8_t* bytes, size_t len, Image* out) {
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  PngMem mem{bytes, len, 0};
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_set_read_fn(png, &mem, png_mem_read);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr, nullptr);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_COLOR) png_set_rgb_to_gray(png, 1, -1, -1);
  if (bit_depth == 16) png_set_strip_16(png);  // trainId masks are 8-bit values
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  out->h = h;
  out->w = w;
  out->c = 1;
  out->data.resize(size_t(h) * w);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out->data.data() + size_t(y) * w;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_png_gray(const std::string& path, uint64_t off, uint64_t len, Image* out) {
  std::vector<uint8_t> buf;
  if (!read_span(path, off, len, &buf)) return false;
  return decode_png_gray_mem(buf.data(), buf.size(), out);
}

// ------------------------------------------------------------------- warp

// dst(x, y) = src(M^-1 [x, y, 1]); M row-major 2x3 (cv2.warpAffine default).
void invert_affine(const double M[6], double inv[6]) {
  double a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5];
  double det = a * e - b * d;
  double ia = e / det, ib = -b / det;
  double id = -d / det, ie = a / det;
  inv[0] = ia; inv[1] = ib; inv[2] = -(ia * c + ib * f);
  inv[3] = id; inv[4] = ie; inv[5] = -(id * c + ie * f);
}

void warp_bilinear_rgb(const Image& src, int oh, int ow, const double M[6],
                       uint8_t border, uint8_t* dst /* oh*ow*3 */) {
  double inv[6];
  invert_affine(M, inv);
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      double sx = inv[0] * x + inv[1] * y + inv[2];
      double sy = inv[3] * x + inv[4] * y + inv[5];
      int x0 = (int)std::floor(sx), y0 = (int)std::floor(sy);
      double wx = sx - x0, wy = sy - y0;
      uint8_t* d = dst + (size_t(y) * ow + x) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        auto fetch = [&](int yy, int xx) -> double {
          if (xx < 0 || xx >= src.w || yy < 0 || yy >= src.h) return border;
          return src.data[(size_t(yy) * src.w + xx) * 3 + ch];
        };
        double v = fetch(y0, x0) * (1 - wx) * (1 - wy) +
                   fetch(y0, x0 + 1) * wx * (1 - wy) +
                   fetch(y0 + 1, x0) * (1 - wx) * wy +
                   fetch(y0 + 1, x0 + 1) * wx * wy;
        d[ch] = (uint8_t)(v + 0.5);
      }
    }
  }
}

void warp_nearest_gray(const Image& src, int oh, int ow, const double M[6],
                       uint8_t border, uint8_t* dst /* oh*ow */) {
  double inv[6];
  invert_affine(M, inv);
  for (int y = 0; y < oh; ++y) {
    for (int x = 0; x < ow; ++x) {
      double sx = inv[0] * x + inv[1] * y + inv[2];
      double sy = inv[3] * x + inv[4] * y + inv[5];
      int xi = (int)std::lround(sx), yi = (int)std::lround(sy);
      dst[size_t(y) * ow + x] =
          (xi < 0 || xi >= src.w || yi < 0 || yi >= src.h)
              ? border
              : src.data[size_t(yi) * src.w + xi];
    }
  }
}

// ----------------------------------------------------------------- loader

struct SampleDesc {
  std::string image_path;
  std::string seg_path;  // empty if none
  // byte spans inside a record store (0,0 = the path is a plain file)
  uint64_t img_off = 0, img_len = 0, seg_off = 0, seg_len = 0;
  float label[kMaxObjects * kLabelWidth];
};

struct Batch {
  std::vector<float> images;      // B*H*W*3 (f32 mode)
  std::vector<uint8_t> images_u8; // B*H*W*3 (u8 mode: RGB, no mean-sub)
  std::vector<float> labels;      // B*200*6
  std::vector<int32_t> segs;      // B*(H/4)*(W/4)
  int count = 0;
};

struct Loader {
  int H, W, batch_size, num_threads, queue_cap;
  float mean[3];
  bool enable_aug;
  bool u8_mode = false;  // emit warped uint8; caller normalizes on device
  bool pad_last = false; // emit a final partial batch, padded (eval paths)
  bool s2d = false;      // emit the 2x2 space-to-depth layout
                         // [H/2, W/2, 12] (channel order (dy, dx, c), c
                         // minor — models/layers.space_to_depth): the H2D
                         // DMA then writes the resnet stem's input
                         // arrangement directly and NO relayout copy
                         // exists on device (docs/ROOFLINE.md r5)
  uint8_t seg_lut[256];

  std::vector<SampleDesc> samples;
  // epoch state
  std::vector<int32_t> order;
  std::vector<double> aug;  // per cursor position: 6 doubles
  std::atomic<int> next_index{0};
  int num_batches = 0;
  int n_total = 0;  // samples this epoch (order length)

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Batch> queue;
  std::vector<std::pair<int, Batch>> out_of_order;  // batches finished early
  int next_emit = 0;  // batch id to emit next (keeps deterministic order)
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int> epoch_token{0};
};

void transform_boxes(Loader* L, float* label, const double* p) {
  // exact port of the augmentation box path (iterator.py:485-539)
  double flip = p[0], theta = p[1], sx = p[2], sy = p[3], tx = p[4], ty = p[5];
  int W = L->W, H = L->H;
  double ca = std::cos(theta), sa = std::sin(theta);
  float rows[kMaxObjects][kLabelWidth];
  int n_out = 0;
  bool any_valid = false;
  for (int i = 0; i < kMaxObjects; ++i) any_valid |= (label[i * kLabelWidth] >= 0);
  if (!any_valid) return;
  for (int i = 0; i < kMaxObjects; ++i) {
    float* r = label + i * kLabelWidth;
    if (r[0] < 0) continue;
    double x1 = r[1] * W, y1 = r[2] * H, x2 = r[3] * W, y2 = r[4] * H;
    double nx1 = sx * ca * x1 - sy * sa * y1 + tx;
    double ny1 = sx * sa * x1 + sy * ca * y1 + ty;
    double nx2 = sx * ca * x2 - sy * sa * y2 + tx;
    double ny2 = sx * sa * x2 + sy * ca * y2 + ty;
    if (flip > 0.5) {
      nx1 = W - nx1;
      nx2 = W - nx2;
      std::swap(nx1, nx2);
    }
    nx1 /= W; ny1 /= H; nx2 /= W; ny2 /= H;
    nx1 = std::fmin(1.0, std::fmax(0.0, nx1));
    ny1 = std::fmin(1.0, std::fmax(0.0, ny1));
    nx2 = std::fmin(1.0, std::fmax(0.0, nx2));
    ny2 = std::fmin(1.0, std::fmax(0.0, ny2));
    double dist = r[5] / std::sqrt(sx * sy);
    // filters (iterator.py:522-534)
    double area = (nx2 - nx1) * W * (ny2 - ny1) * H;
    if (area < 100.0) continue;
    if (nx2 < 0.01 || nx1 > 0.99 || ny2 < 0.01 || ny1 > 0.99) continue;
    rows[n_out][0] = r[0];
    rows[n_out][1] = (float)nx1;
    rows[n_out][2] = (float)ny1;
    rows[n_out][3] = (float)nx2;
    rows[n_out][4] = (float)ny2;
    rows[n_out][5] = (float)dist;
    ++n_out;
  }
  for (int i = 0; i < kMaxObjects * kLabelWidth; ++i) label[i] = -1.f;
  std::memcpy(label, rows, size_t(n_out) * kLabelWidth * sizeof(float));
}

void filter_small_boxes(Loader* L, float* label) {
  // no-aug path: small-area filter + compact only (iterator.py:458-469)
  float rows[kMaxObjects][kLabelWidth];
  int n_out = 0;
  for (int i = 0; i < kMaxObjects; ++i) {
    float* r = label + i * kLabelWidth;
    if (r[0] < 0) continue;
    double area = (r[3] - r[1]) * L->W * (r[4] - r[2]) * L->H;
    if (area < 100.0) continue;
    std::memcpy(rows[n_out++], r, kLabelWidth * sizeof(float));
  }
  for (int i = 0; i < kMaxObjects * kLabelWidth; ++i) label[i] = -1.f;
  std::memcpy(label, rows, size_t(n_out) * kLabelWidth * sizeof(float));
}

void process_one(Loader* L, int cursor, int slot, Batch* batch) {
  const SampleDesc& s = L->samples[L->order[cursor]];
  Image img, seg;
  bool has_img = decode_jpeg(s.image_path, s.img_off, s.img_len, &img);
  bool has_seg = !s.seg_path.empty() &&
                 decode_png_gray(s.seg_path, s.seg_off, s.seg_len, &seg);
  int H = L->H, W = L->W;
  float* out_img = L->u8_mode ? nullptr
      : batch->images.data() + size_t(slot) * H * W * 3;
  uint8_t* out_u8 = L->u8_mode
      ? batch->images_u8.data() + size_t(slot) * H * W * 3 : nullptr;
  float* out_lbl = batch->labels.data() + size_t(slot) * kMaxObjects * kLabelWidth;
  int32_t* out_seg = batch->segs.data() + size_t(slot) * (H / 4) * (W / 4);
  std::memcpy(out_lbl, s.label, sizeof(s.label));
  if (!has_img) {
    if (L->u8_mode)
      std::memset(out_u8, 0, size_t(H) * W * 3);
    else
      std::memset(out_img, 0, size_t(H) * W * 3 * sizeof(float));
    return;
  }

  const double* p = L->aug.data() + size_t(cursor) * 6;
  double ident[6] = {0, 0, 1, 1, 0, 0};
  if (!L->enable_aug) p = ident;
  double flip = p[0], theta = p[1], sx = p[2], sy = p[3], tx = p[4], ty = p[5];
  double sx2 = sx * (double(W) / img.w), sy2 = sy * (double(H) / img.h);
  double ca = std::cos(theta), sa = std::sin(theta);
  double M[6] = {sx2 * ca, -sy2 * sa, tx, sx2 * sa, sy2 * ca, ty};

  std::vector<uint8_t> warped(size_t(H) * W * 3);
  warp_bilinear_rgb(img, H, W, M, L->enable_aug ? 128 : 0, warped.data());
  std::vector<uint8_t> seg_warp;
  if (has_seg) {
    seg_warp.resize(size_t(H) * W);
    warp_nearest_gray(seg, H, W, M, L->enable_aug ? 255 : 0, seg_warp.data());
  }

  if (L->enable_aug) {
    transform_boxes(L, out_lbl, p);
  } else {
    filter_small_boxes(L, out_lbl);
  }

  bool do_flip = L->enable_aug && flip > 0.5;
  // destination offset of output pixel (y, x): plain NHWC, or the 2x2
  // space-to-depth arrangement when s2d is set (same total bytes; the
  // permutation costs nothing here — every pixel is written exactly once
  // either way)
  const int Wh = W >> 1;
  const bool s2d = L->s2d;
  auto dst_off = [&](int y, int x) -> size_t {
    if (!s2d) return (size_t(y) * W + x) * 3;
    return (size_t(y >> 1) * Wh + (x >> 1)) * 12 +
           size_t(((y & 1) << 1) + (x & 1)) * 3;
  };
  if (L->u8_mode) {
    // raw warped RGB uint8 (+ flip); mean-sub runs on device — 4x less
    // host->device traffic than the f32 batch
    for (int y = 0; y < H; ++y) {
      for (int x = 0; x < W; ++x) {
        int xs = do_flip ? (W - 1 - x) : x;
        const uint8_t* sp = warped.data() + (size_t(y) * W + xs) * 3;
        uint8_t* dp = out_u8 + dst_off(y, x);
        dp[0] = sp[0]; dp[1] = sp[1]; dp[2] = sp[2];
      }
    }
  } else {
    // mean-sub RGB float NHWC (+ horizontal flip applied during copy)
    for (int y = 0; y < H; ++y) {
      for (int x = 0; x < W; ++x) {
        int xs = do_flip ? (W - 1 - x) : x;
        const uint8_t* sp = warped.data() + (size_t(y) * W + xs) * 3;
        float* dp = out_img + dst_off(y, x);
        dp[0] = sp[0] - L->mean[0];
        dp[1] = sp[1] - L->mean[1];
        dp[2] = sp[2] - L->mean[2];
      }
    }
  }
  if (has_seg) {
    // 1/4-res nearest (cv2.resize INTER_NEAREST sampling: src = floor(dst*4))
    int h4 = H / 4, w4 = W / 4;
    for (int y = 0; y < h4; ++y) {
      for (int x = 0; x < w4; ++x) {
        int xs = do_flip ? (W - 1 - x * 4) : x * 4;
        out_seg[size_t(y) * w4 + x] = L->seg_lut[seg_warp[size_t(y * 4) * W + xs]];
      }
    }
  } else {
    // maskless sample: ignore label 255, NOT 0 — a zero fill would train
    // the seg head toward 'road' for this image
    std::fill(out_seg, out_seg + size_t(H / 4) * (W / 4), 255);
  }
}

void worker_main(Loader* L) {
  while (!L->stop.load()) {
    int bidx = L->next_index.fetch_add(1);
    if (bidx >= L->num_batches) {
      // wait for a new epoch or shutdown
      std::unique_lock<std::mutex> lk(L->mu);
      int tok = L->epoch_token.load();
      L->cv_push.wait(lk, [&] {
        return L->stop.load() || L->epoch_token.load() != tok;
      });
      continue;
    }
    Batch batch;
    int B = L->batch_size;
    if (L->u8_mode)
      batch.images_u8.assign(size_t(B) * L->H * L->W * 3, 0);
    else
      batch.images.assign(size_t(B) * L->H * L->W * 3, 0.f);
    batch.labels.assign(size_t(B) * kMaxObjects * kLabelWidth, -1.f);
    // padded slots (pad_last final batch) stay ignore-255 / -1 / zero
    batch.segs.assign(size_t(B) * (L->H / 4) * (L->W / 4), 255);
    batch.count = std::min(B, L->n_total - bidx * B);
    for (int i = 0; i < batch.count; ++i) process_one(L, bidx * B + i, i, &batch);
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_pop.wait(lk, [&] {
        return L->stop.load() || (int)L->queue.size() < L->queue_cap;
      });
      if (L->stop.load()) return;
      L->out_of_order.emplace_back(bidx, std::move(batch));
      // emit in deterministic batch order
      bool emitted = true;
      while (emitted) {
        emitted = false;
        for (auto it = L->out_of_order.begin(); it != L->out_of_order.end(); ++it) {
          if (it->first == L->next_emit) {
            L->queue.push_back(std::move(it->second));
            L->out_of_order.erase(it);
            L->next_emit++;
            emitted = true;
            break;
          }
        }
      }
    }
    L->cv_push.notify_all();
  }
}

}  // namespace

extern "C" {

void* dl_create(int H, int W, int batch_size, int num_threads, int queue_cap,
                const float* mean_rgb, int enable_aug, const uint8_t* seg_lut) {
  Loader* L = new Loader();
  L->H = H;
  L->W = W;
  L->batch_size = batch_size;
  L->num_threads = num_threads;
  L->queue_cap = queue_cap;
  std::memcpy(L->mean, mean_rgb, 3 * sizeof(float));
  L->enable_aug = enable_aug != 0;
  std::memcpy(L->seg_lut, seg_lut, 256);
  return L;
}

void dl_add_sample(void* handle, const char* image_path, const char* seg_path,
                   const float* label /* 200*6 */) {
  Loader* L = (Loader*)handle;
  SampleDesc s;
  s.image_path = image_path;
  s.seg_path = seg_path ? seg_path : "";
  std::memcpy(s.label, label, sizeof(s.label));
  L->samples.push_back(std::move(s));
}

// Span-backed variant for packed .drec stores (dspnet_tpu/data/record.py):
// the paths point at the store file, (off, len) at the encoded bytes.
void dl_add_sample2(void* handle, const char* image_path,
                    unsigned long long img_off, unsigned long long img_len,
                    const char* seg_path,
                    unsigned long long seg_off, unsigned long long seg_len,
                    const float* label /* 200*6 */) {
  Loader* L = (Loader*)handle;
  SampleDesc s;
  s.image_path = image_path;
  s.seg_path = seg_path ? seg_path : "";
  s.img_off = img_off;
  s.img_len = img_len;
  s.seg_off = seg_off;
  s.seg_len = seg_len;
  std::memcpy(s.label, label, sizeof(s.label));
  L->samples.push_back(std::move(s));
}

// order: shuffled sample indices; aug: num_samples*6 doubles (flip, theta,
// sx, sy, tx, ty) indexed by cursor position — both produced Python-side
// with numpy seed 233 for parity with the reference.
void dl_start_epoch(void* handle, const int32_t* order, const double* aug, int n) {
  Loader* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->order.assign(order, order + n);
    L->aug.assign(aug, aug + size_t(n) * 6);
    L->n_total = n;
    L->num_batches = (L->pad_last && n % L->batch_size)
                         ? n / L->batch_size + 1
                         : n / L->batch_size;
    L->next_index.store(0);
    L->next_emit = 0;
    L->queue.clear();
    L->out_of_order.clear();
    L->epoch_token.fetch_add(1);
  }
  if (L->workers.empty()) {
    for (int i = 0; i < L->num_threads; ++i)
      L->workers.emplace_back(worker_main, L);
  }
  L->cv_push.notify_all();
}

int dl_num_batches(void* handle) { return ((Loader*)handle)->num_batches; }

// Blocking pop. Returns batch count (0 on shutdown).
int dl_next_batch(void* handle, float* images, float* labels, int32_t* segs) {
  Loader* L = (Loader*)handle;
  Batch b;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_push.wait(lk, [&] { return L->stop.load() || !L->queue.empty(); });
    if (L->stop.load() && L->queue.empty()) return 0;
    b = std::move(L->queue.front());
    L->queue.pop_front();
  }
  L->cv_pop.notify_all();
  std::memcpy(images, b.images.data(), b.images.size() * sizeof(float));
  std::memcpy(labels, b.labels.data(), b.labels.size() * sizeof(float));
  std::memcpy(segs, b.segs.data(), b.segs.size() * sizeof(int32_t));
  return b.count;
}

// Switch to uint8 output (call before the first dl_start_epoch).
void dl_set_u8(void* handle, int enable) {
  ((Loader*)handle)->u8_mode = enable != 0;
}

// Also emit a final partial batch, padded with empty rows (zero image,
// -1 labels, ignore-255 seg); dl_next_batch's return value is the REAL
// sample count. Call before the first dl_start_epoch (eval paths).
void dl_set_pad_last(void* handle, int enable) {
  ((Loader*)handle)->pad_last = enable != 0;
}

// Emit images in the 2x2 space-to-depth layout [H/2, W/2, 12] (requires
// even H and W). Call before the first dl_start_epoch.
void dl_set_s2d(void* handle, int enable) {
  ((Loader*)handle)->s2d = enable != 0;
}

// Blocking pop, uint8 mode. Returns batch count (0 on shutdown, -1 if the
// loader is not in u8 mode).
int dl_next_batch_u8(void* handle, uint8_t* images, float* labels, int32_t* segs) {
  Loader* L = (Loader*)handle;
  if (!L->u8_mode) return -1;
  Batch b;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_push.wait(lk, [&] { return L->stop.load() || !L->queue.empty(); });
    if (L->stop.load() && L->queue.empty()) return 0;
    b = std::move(L->queue.front());
    L->queue.pop_front();
  }
  L->cv_pop.notify_all();
  std::memcpy(images, b.images_u8.data(), b.images_u8.size());
  std::memcpy(labels, b.labels.data(), b.labels.size() * sizeof(float));
  std::memcpy(segs, b.segs.data(), b.segs.size() * sizeof(int32_t));
  return b.count;
}

void dl_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  L->stop.store(true);
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
