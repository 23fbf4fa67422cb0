// Native training-data loader: .npy stamp archives to float32 batches.
//
// A copy of the JAX package's debvader_tpu/runtime/dataloader.cpp: the code
// below this header is byte for byte the same, so the two packages read,
// shuffle and convert identically.  Only this header differs.
//
// The archives are mmap'd (zero-copy until touched); a background thread
// assembles batches (row gather and float64 -> float32 conversion) into a
// bounded queue of staging buffers, reshuffling the row order with a
// seeded mt19937_64 at each epoch, while the Python side
// (runtime/loader.py) uploads the batch before.  A plain C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 dataloader.cpp -o libdvloader.so
// (runtime/loader.py does this at first use, into _build/).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct NpyArray {
  void* map_base = nullptr;
  size_t map_len = 0;
  const char* data = nullptr;  // first element
  std::vector<int64_t> shape;
  char dtype_kind = 'f';
  int itemsize = 0;
  bool little_endian = true;

  int64_t rows() const { return shape.empty() ? 0 : shape[0]; }
  int64_t row_elems() const {
    int64_t n = 1;
    for (size_t i = 1; i < shape.size(); ++i) n *= shape[i];
    return n;
  }
};

bool parse_npy(const char* path, NpyArray* out, std::string* err) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) { *err = "open failed: " + std::string(path); return false; }
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); *err = "fstat failed"; return false; }
  void* base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (base == MAP_FAILED) { *err = "mmap failed"; return false; }
  const unsigned char* p = static_cast<const unsigned char*>(base);
  if (st.st_size < 10 || memcmp(p, "\x93NUMPY", 6) != 0) {
    ::munmap(base, st.st_size);
    *err = "not a .npy file";
    return false;
  }
  int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    header_len = p[8] | (p[9] << 8) | (p[10] << 16) | (size_t(p[11]) << 24);
    header_off = 12;
  }
  std::string header(reinterpret_cast<const char*>(p + header_off), header_len);

  auto find_value = [&](const std::string& key) -> std::string {
    size_t k = header.find("'" + key + "'");
    if (k == std::string::npos) return "";
    size_t c = header.find(':', k);
    return header.substr(c + 1);
  };

  std::string descr = find_value("descr");
  size_t q0 = descr.find('\'');
  size_t q1 = descr.find('\'', q0 + 1);
  std::string ds = descr.substr(q0 + 1, q1 - q0 - 1);  // e.g. "<f8"
  size_t di = 0;
  if (!ds.empty() && (ds[0] == '<' || ds[0] == '>' || ds[0] == '=' || ds[0] == '|')) {
    out->little_endian = ds[0] != '>';
    di = 1;
  }
  out->dtype_kind = di < ds.size() ? ds[di] : '?';
  out->itemsize = di + 1 < ds.size() ? std::atoi(ds.c_str() + di + 1) : 0;
  // convert_row only understands f4/f8/i4; fail loudly at open instead of
  // zero-filling batches at runtime.
  bool supported =
      (out->dtype_kind == 'f' && (out->itemsize == 4 || out->itemsize == 8)) ||
      (out->dtype_kind == 'i' && out->itemsize == 4);
  if (!supported || !out->little_endian) {
    ::munmap(base, st.st_size);
    *err = "unsupported dtype '" + ds + "' in " + std::string(path) +
           " (need little-endian f4/f8/i4)";
    return false;
  }

  std::string fortran = find_value("fortran_order");
  if (fortran.find("True") != std::string::npos) {
    ::munmap(base, st.st_size);
    *err = "fortran order unsupported";
    return false;
  }

  std::string shp = find_value("shape");
  size_t l = shp.find('('), r = shp.find(')');
  std::string dims = shp.substr(l + 1, r - l - 1);
  out->shape.clear();
  int64_t cur = -1;
  for (char c : dims) {
    if (c >= '0' && c <= '9') {
      cur = (cur < 0 ? 0 : cur) * 10 + (c - '0');
    } else if (cur >= 0) {
      out->shape.push_back(cur);
      cur = -1;
    }
  }
  if (cur >= 0) out->shape.push_back(cur);

  out->map_base = base;
  out->map_len = st.st_size;
  out->data = reinterpret_cast<const char*>(p + header_off + header_len);
  return true;
}

// Convert one source row into a float32 destination row.
void convert_row(const NpyArray& arr, int64_t row, float* dst) {
  const char* src = arr.data + row * arr.row_elems() * arr.itemsize;
  int64_t n = arr.row_elems();
  if (arr.dtype_kind == 'f' && arr.itemsize == 4) {
    memcpy(dst, src, n * 4);
  } else if (arr.dtype_kind == 'f' && arr.itemsize == 8) {
    const double* s = reinterpret_cast<const double*>(src);
    for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<float>(s[i]);
  } else {
    // dvl_open rejects anything else; only i4 remains.
    const int32_t* s = reinterpret_cast<const int32_t*>(src);
    for (int64_t i = 0; i < n; ++i) dst[i] = static_cast<float>(s[i]);
  }
}

struct Batch {
  std::vector<float> x;
  std::vector<float> y;
  int64_t n = 0;
};

struct Loader {
  NpyArray xs, ys;
  int64_t batch_size = 0;
  bool shuffle = true;
  uint64_t seed = 0;
  int64_t epoch = 0;

  std::vector<int64_t> order;
  int64_t cursor = 0;  // next row index into `order`

  // prefetch machinery
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::queue<Batch> ready;
  size_t max_queue = 4;
  std::atomic<bool> stop{false};

  void reshuffle() {
    order.resize(xs.rows());
    for (int64_t i = 0; i < xs.rows(); ++i) order[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (epoch + 1));
      for (int64_t i = xs.rows() - 1; i > 0; --i) {
        int64_t j = rng() % (i + 1);
        std::swap(order[i], order[j]);
      }
    }
    cursor = 0;
  }

  void fill_loop() {
    while (!stop.load()) {
      Batch b;
      {
        // build next batch from current epoch order
        if (cursor + batch_size > xs.rows()) {
          epoch++;
          reshuffle();
        }
        b.n = batch_size;
        b.x.resize(batch_size * xs.row_elems());
        b.y.resize(batch_size * ys.row_elems());
        for (int64_t i = 0; i < batch_size; ++i) {
          int64_t row = order[cursor + i];
          convert_row(xs, row, b.x.data() + i * xs.row_elems());
          convert_row(ys, row, b.y.data() + i * ys.row_elems());
        }
        cursor += batch_size;
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] { return ready.size() < max_queue || stop.load(); });
      if (stop.load()) return;
      ready.push(std::move(b));
      cv_ready.notify_one();
    }
  }
};

std::string g_last_error;

}  // namespace

extern "C" {

void* dvl_open(const char* x_path, const char* y_path, int64_t batch_size,
               int shuffle, uint64_t seed) {
  auto* L = new Loader();
  std::string err;
  if (!parse_npy(x_path, &L->xs, &err) || !parse_npy(y_path, &L->ys, &err)) {
    g_last_error = err;
    delete L;
    return nullptr;
  }
  if (L->xs.rows() != L->ys.rows() || L->xs.rows() < batch_size) {
    g_last_error = "row mismatch or fewer rows than batch size";
    delete L;
    return nullptr;
  }
  L->batch_size = batch_size;
  L->shuffle = shuffle != 0;
  L->seed = seed;
  L->reshuffle();
  L->worker = std::thread([L] { L->fill_loop(); });
  return L;
}

const char* dvl_last_error() { return g_last_error.c_str(); }

int64_t dvl_rows(void* h) { return static_cast<Loader*>(h)->xs.rows(); }
int64_t dvl_x_row_elems(void* h) { return static_cast<Loader*>(h)->xs.row_elems(); }
int64_t dvl_y_row_elems(void* h) { return static_cast<Loader*>(h)->ys.row_elems(); }

int64_t dvl_ndim_x(void* h) { return static_cast<Loader*>(h)->xs.shape.size(); }
void dvl_shape_x(void* h, int64_t* out) {
  auto& s = static_cast<Loader*>(h)->xs.shape;
  for (size_t i = 0; i < s.size(); ++i) out[i] = s[i];
}

int64_t dvl_ndim_y(void* h) { return static_cast<Loader*>(h)->ys.shape.size(); }
void dvl_shape_y(void* h, int64_t* out) {
  auto& s = static_cast<Loader*>(h)->ys.shape;
  for (size_t i = 0; i < s.size(); ++i) out[i] = s[i];
}

// Blocking: copies the next prefetched batch into caller buffers.
int dvl_next(void* h, float* x_out, float* y_out) {
  auto* L = static_cast<Loader*>(h);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] { return !L->ready.empty() || L->stop.load(); });
    if (L->stop.load()) return -1;
    b = std::move(L->ready.front());
    L->ready.pop();
    L->cv_space.notify_one();
  }
  memcpy(x_out, b.x.data(), b.x.size() * sizeof(float));
  memcpy(y_out, b.y.data(), b.y.size() * sizeof(float));
  return static_cast<int>(b.n);
}

void dvl_close(void* h) {
  auto* L = static_cast<Loader*>(h);
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  if (L->worker.joinable()) L->worker.join();
  if (L->xs.map_base) ::munmap(L->xs.map_base, L->xs.map_len);
  if (L->ys.map_base) ::munmap(L->ys.map_base, L->ys.map_len);
  delete L;
}

}  // extern "C"
