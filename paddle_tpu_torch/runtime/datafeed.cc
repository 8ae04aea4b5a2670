// The port's copy of the JAX package's runtime/datafeed.cc, built by
// paddle_tpu_torch/runtime/__init__.py into build/runtime/.
//
// Native datafeed runtime: multi-threaded MultiSlot text parsing + a bounded
// channel, the TPU-framework equivalent of the reference's C++ data pipeline
// (framework/data_feed.h:61 MultiSlotDataFeed, framework/channel.h
// ChannelObject, framework/data_set.h:41 DatasetImpl).
//
// Line format (MultiSlot, data_feed.cc contract): per used slot, an integer
// count n followed by n whitespace-separated values.  Slot schema string:
// "u:LEN" (int64 ids, padded/truncated to LEN) or "f:LEN" (float32, dense,
// exactly LEN values expected) joined by ';' in slot order.
//
// Two access modes mirroring QueueDataset vs InMemoryDataset:
//   streaming:  df_open / df_next_batch / df_close  (bounded channel)
//   in-memory:  df_load / df_rows / df_fetch / df_free (random-access gather
//               so Python can shuffle/partition by row index)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  char type;  // 'u' -> int64, 'f' -> float32
  int len;    // padded per-record length
};

struct Schema {
  std::vector<Slot> slots;
  int int_len = 0;    // total int64 values per record
  int float_len = 0;  // total float32 values per record
};

Schema parse_schema(const char* s) {
  Schema sc;
  const char* p = s;
  while (*p) {
    Slot sl;
    sl.type = *p++;
    if (*p == ':') ++p;
    sl.len = std::atoi(p);
    while (*p && *p != ';') ++p;
    if (*p == ';') ++p;
    if (sl.type == 'u')
      sc.int_len += sl.len;
    else
      sc.float_len += sl.len;
    sc.slots.push_back(sl);
  }
  return sc;
}

// One parsed record: fixed layout (all int slots concatenated, then all
// float slots concatenated) so gather/batch assembly is a memcpy.
struct Record {
  std::vector<int64_t> ints;
  std::vector<float> floats;
};

// Parse one line into rec; returns false on malformed input (bad count /
// missing values), in which case the line is dropped and counted.
bool parse_line(const char* line, const Schema& sc, Record* rec) {
  rec->ints.assign(sc.int_len, 0);
  rec->floats.assign(sc.float_len, 0.f);
  const char* p = line;
  int ioff = 0, foff = 0;
  for (const Slot& sl : sc.slots) {
    char* end = nullptr;
    long n = std::strtol(p, &end, 10);
    if (end == p || n < 0) return false;
    p = end;
    for (long i = 0; i < n; ++i) {
      if (sl.type == 'u') {
        long long v = std::strtoll(p, &end, 10);
        if (end == p) return false;
        if (i < sl.len) rec->ints[ioff + i] = (int64_t)v;
      } else {
        float v = std::strtof(p, &end);
        if (end == p) return false;
        if (i < sl.len) rec->floats[foff + i] = v;
      }
      p = end;
    }
    if (sl.type == 'u')
      ioff += sl.len;
    else
      foff += sl.len;
  }
  return true;
}

// Bounded multi-producer single-consumer channel (ChannelObject analogue).
class Channel {
 public:
  explicit Channel(size_t cap) : cap_(cap) {}

  void put(Record&& r) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_put_.wait(lk, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return;
    q_.push(std::move(r));
    cv_get_.notify_one();
  }

  bool get(Record* r) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_get_.wait(lk, [&] { return !q_.empty() || done_ || closed_; });
    if (q_.empty()) return false;
    *r = std::move(q_.front());
    q_.pop();
    cv_put_.notify_one();
    return true;
  }

  void producer_done() {
    std::unique_lock<std::mutex> lk(mu_);
    if (--producers_ == 0) done_ = true;
    cv_get_.notify_all();
  }

  void add_producers(int n) { producers_ += n; }

  void close() {
    std::unique_lock<std::mutex> lk(mu_);
    closed_ = true;
    cv_put_.notify_all();
    cv_get_.notify_all();
  }

  // lock-free probe so reader threads can bail out mid-file on close
  bool is_closed() const { return closed_.load(std::memory_order_relaxed); }

 private:
  std::mutex mu_;
  std::condition_variable cv_put_, cv_get_;
  std::queue<Record> q_;
  size_t cap_;
  int producers_ = 0;
  bool done_ = false;
  std::atomic<bool> closed_{false};
};

// sink (when used instead of ch) must be owned exclusively by this call:
// deterministic record order is part of df_load's contract.
void read_file_into(const std::string& path, const Schema& sc, Channel* ch,
                    std::vector<Record>* sink, long* dropped) {
  FILE* f = std::fopen(path.c_str(), "r");
  if (!f) return;
  char* line = nullptr;
  size_t cap = 0;
  ssize_t got;
  long local_dropped = 0;
  while ((got = getline(&line, &cap, f)) != -1) {
    if (ch && ch->is_closed()) break;  // consumer gone: stop parsing promptly
    if (got == 0 || line[0] == '\n') continue;
    Record rec;
    if (!parse_line(line, sc, &rec)) {
      ++local_dropped;
      continue;
    }
    if (ch) {
      ch->put(std::move(rec));
    } else {
      sink->push_back(std::move(rec));
    }
  }
  std::free(line);
  std::fclose(f);
  if (dropped) {
    __atomic_add_fetch(dropped, local_dropped, __ATOMIC_RELAXED);
  }
}

struct FileQueue {
  std::vector<std::string> files;
  std::atomic<size_t> next{0};
};

}  // namespace

// ---------------------------------------------------------------------------
// Streaming session (QueueDataset path)
// ---------------------------------------------------------------------------

struct DF_Session {
  Schema schema;
  Channel channel{4096};
  FileQueue fq;
  std::vector<std::thread> workers;
  long dropped = 0;
};

extern "C" {

DF_Session* df_open(const char** files, int n_files, const char* schema,
                    int n_threads) {
  DF_Session* s = new DF_Session();
  s->schema = parse_schema(schema);
  for (int i = 0; i < n_files; ++i) s->fq.files.emplace_back(files[i]);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_files) n_threads = n_files > 0 ? n_files : 1;
  s->channel.add_producers(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    s->workers.emplace_back([s] {
      size_t i;
      while (!s->channel.is_closed() &&
             (i = s->fq.next.fetch_add(1)) < s->fq.files.size()) {
        read_file_into(s->fq.files[i], s->schema, &s->channel, nullptr,
                       &s->dropped);
      }
      s->channel.producer_done();
    });
  }
  return s;
}

// Fill per-slot buffers (row-major [batch, slot.len]); returns rows filled
// (0 = end of stream).  out_ptrs order matches schema slot order.
int df_next_batch(DF_Session* s, int batch_size, void** out_ptrs) {
  int row = 0;
  Record rec;
  while (row < batch_size && s->channel.get(&rec)) {
    int ioff = 0, foff = 0, si = 0;
    for (const Slot& sl : s->schema.slots) {
      if (sl.type == 'u') {
        std::memcpy((int64_t*)out_ptrs[si] + (size_t)row * sl.len,
                    rec.ints.data() + ioff, sl.len * sizeof(int64_t));
        ioff += sl.len;
      } else {
        std::memcpy((float*)out_ptrs[si] + (size_t)row * sl.len,
                    rec.floats.data() + foff, sl.len * sizeof(float));
        foff += sl.len;
      }
      ++si;
    }
    ++row;
  }
  return row;
}

long df_dropped(DF_Session* s) { return s->dropped; }

void df_close(DF_Session* s) {
  s->channel.close();
  for (auto& t : s->workers) t.join();
  delete s;
}

// ---------------------------------------------------------------------------
// In-memory dataset (InMemoryDataset path): parse-all + random-access gather
// ---------------------------------------------------------------------------

struct DF_Data {
  Schema schema;
  std::vector<Record> records;
  long dropped = 0;
};

DF_Data* df_load(const char** files, int n_files, const char* schema,
                 int n_threads) {
  DF_Data* d = new DF_Data();
  d->schema = parse_schema(schema);
  FileQueue fq;
  for (int i = 0; i < n_files; ++i) fq.files.emplace_back(files[i]);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_files) n_threads = n_files > 0 ? n_files : 1;
  // Row order must be deterministic regardless of thread scheduling: every
  // worker that trusts row indices (e.g. InMemoryDataset.global_shuffle's
  // hash partition) must agree on which record sits at row i.  Each file
  // parses into its own vector (no lock needed — one worker owns a file at
  // a time), then vectors concatenate in filelist order.
  std::vector<std::vector<Record>> per_file(fq.files.size());
  std::vector<std::thread> ws;
  for (int t = 0; t < n_threads; ++t) {
    ws.emplace_back([&, d] {
      size_t i;
      while ((i = fq.next.fetch_add(1)) < fq.files.size()) {
        read_file_into(fq.files[i], d->schema, nullptr, &per_file[i],
                       &d->dropped);
      }
    });
  }
  for (auto& t : ws) t.join();
  size_t total = 0;
  for (const auto& pf : per_file) total += pf.size();
  d->records.reserve(total);
  for (auto& pf : per_file) {
    for (auto& rec : pf) d->records.push_back(std::move(rec));
  }
  return d;
}

long df_rows(DF_Data* d) { return (long)d->records.size(); }

long df_data_dropped(DF_Data* d) { return d->dropped; }

// Gather rows by index into per-slot buffers (row-major [n, slot.len]).
void df_fetch(DF_Data* d, const long* idx, int n, void** out_ptrs) {
  for (int r = 0; r < n; ++r) {
    const Record& rec = d->records[idx[r]];
    int ioff = 0, foff = 0, si = 0;
    for (const Slot& sl : d->schema.slots) {
      if (sl.type == 'u') {
        std::memcpy((int64_t*)out_ptrs[si] + (size_t)r * sl.len,
                    rec.ints.data() + ioff, sl.len * sizeof(int64_t));
        ioff += sl.len;
      } else {
        std::memcpy((float*)out_ptrs[si] + (size_t)r * sl.len,
                    rec.floats.data() + foff, sl.len * sizeof(float));
        foff += sl.len;
      }
      ++si;
    }
  }
}

void df_free(DF_Data* d) { delete d; }

}  // extern "C"
