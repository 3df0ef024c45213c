// Host-side dependency engine of mxnet_tpu_torch: versioned-variable
// async scheduler.  The port's own copy of the JAX package's
// src/engine.cc (the reference's threaded engine semantics: interface
// `include/mxnet/engine.h:75-229`, variable dependency rules
// `src/engine/threaded_engine.h:44-401`):
//
//  - Every variable is a versioned queue of pending dependencies.
//    Concurrent reads are allowed; a write waits for all prior reads and
//    writes; reads queued behind a write wait for that write.
//  - An operation declares const_vars (reads) and mutable_vars (writes),
//    carries an atomic wait counter, and is dispatched to a worker pool
//    once every dependency is granted.
//  - WaitForVar pushes a read op; WaitForAll drains the pending-op
//    counter (`engine.h:141-147`).  Both have a bounded form here
//    (a timeout in milliseconds), whose caller may leave before the op
//    runs: the op's wait state is shared, not on the waiter's stack.
//  - NaiveEngine mode executes on the pushing thread
//    (`src/engine/naive_engine.cc`).
//  - When profiling is on, each op records start/end microseconds and
//    worker thread id, dumped as Chrome-tracing JSON.
//  - Shutdown: once `Shutdown()` is called no op's callback runs any
//    more (its dependencies still complete), so a worker never enters
//    the Python interpreter while it is being torn down.
//
// It schedules host work (PrefetchingIter's fetches); the card's work
// is ordered by CUDA streams.  A flat C ABI for ctypes; callbacks
// re-enter Python through one trampoline function pointer.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

inline uint64_t NowUs() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

typedef void (*EngineCallback)(void* ctx);

struct Opr;

// A versioned variable. Grant rules (mirroring ThreadedVar):
//   - read granted iff no write is running and no write is queued ahead
//   - write granted iff nothing is running and the queue ahead is empty
struct Var {
  std::mutex m;
  int running_reads = 0;
  bool running_write = false;
  uint64_t version = 0;
  std::deque<std::pair<Opr*, bool>> waiting;  // (op, is_write)
};

struct Opr {
  EngineCallback fn = nullptr;
  void* ctx = nullptr;
  std::vector<Var*> const_vars;
  std::vector<Var*> mutable_vars;
  std::atomic<int> wait{0};
  int priority = 0;  // 1 => prioritized lane (FnProperty::kCPUPrioritized)
  Var* delete_var = nullptr;  // set by DeleteVar: free after completion
  bool internal = false;      // the engine's own callback (runs always)
  std::string name;
  uint64_t push_us = 0;
};

struct ProfileRecord {
  std::string name;
  uint64_t start_us, end_us;
  int tid;
};

class Engine {
 public:
  Engine(int num_workers, bool naive) : naive_(naive) {
    if (num_workers < 1) num_workers = 1;
    if (!naive_) {
      for (int i = 0; i < num_workers; ++i)
        workers_.emplace_back([this, i] { WorkerLoop(i); });
    }
  }

  ~Engine() {
    WaitForAll();
    {
      std::unique_lock<std::mutex> lk(qm_);
      shutdown_ = true;
    }
    qcv_.notify_all();
    for (auto& t : workers_) t.join();
    for (Var* v : all_vars_) delete v;
  }

  Var* NewVar() {
    Var* v = new Var();
    std::lock_guard<std::mutex> lk(vars_m_);
    all_vars_.push_back(v);
    return v;
  }

  // Engine::DeleteVariable: schedule a write op that frees the var once
  // everything already queued on it has completed.  Using the var after
  // this call is a usage error, as in the reference.
  void DeleteVar(Var* v) {
    if (naive_) {
      ReleaseVar(v);
      return;
    }
    Var* vs[1] = {v};
    Push(nullptr, nullptr, nullptr, 0, vs, 1, /*priority=*/0, "DeleteVar",
         /*delete_var=*/v);
  }

  void Push(EngineCallback fn, void* ctx, Var** cvars, int nc, Var** mvars,
            int nm, int priority, const char* name,
            Var* delete_var = nullptr, bool internal = false) {
    if (naive_) {
      // Synchronous engine: dependencies are trivially satisfied because
      // nothing runs concurrently; still bump versions for observability.
      uint64_t t0 = NowUs();
      if (fn && (internal || !stopping_.load())) fn(ctx);
      uint64_t t1 = NowUs();
      for (int i = 0; i < nm; ++i) mvars[i]->version++;
      if (profiling_.load()) Record(name ? name : "op", t0, t1, 0);
      return;
    }
    Opr* op = new Opr();
    op->fn = fn;
    op->ctx = ctx;
    op->internal = internal;
    op->delete_var = delete_var;
    op->const_vars.assign(cvars, cvars + nc);
    op->mutable_vars.assign(mvars, mvars + nm);
    // Reject duplicates and read/write overlap like the reference's
    // CheckDuplicate (threaded_engine.cc:207): granting a read and a
    // write of the same var to one op deadlocks it permanently.
    Dedup(&op->mutable_vars);
    Dedup(&op->const_vars);
    for (Var* mv : op->mutable_vars) {
      auto& cv = op->const_vars;
      cv.erase(std::remove(cv.begin(), cv.end(), mv), cv.end());
    }
    op->priority = priority;
    op->name = name ? name : "op";
    op->push_us = NowUs();
    pending_.fetch_add(1);
    // +1 guards against dispatch before all deps are registered.
    op->wait.store(static_cast<int>(op->const_vars.size() +
                                    op->mutable_vars.size()) + 1);
    {
      // Registration must be atomic across the op's whole var set:
      // with a total push order every wait edge points at an earlier
      // push, so the wait graph is acyclic.  Interleaved registration
      // of overlapping sets from two threads can otherwise leave each
      // op half-granted — a permanent deadlock.
      std::lock_guard<std::mutex> lk(push_m_);
      for (Var* v : op->const_vars)
        if (AppendRead(v, op)) Satisfy(op);
      for (Var* v : op->mutable_vars)
        if (AppendWrite(v, op)) Satisfy(op);
    }
    Satisfy(op);  // drop the guard
  }

  // Waits until every op pushed on `v` before this call has completed;
  // with timeout_ms >= 0 for at most that long.  Returns true when they
  // have.  The notifying op owns a reference to the wait state, so a
  // waiter that timed out may return first.
  bool WaitForVar(Var* v, long long timeout_ms = -1) {
    if (naive_) return true;
    struct State {
      std::mutex m;
      std::condition_variable cv;
      bool done = false;
    };
    auto* st = new std::shared_ptr<State>(std::make_shared<State>());
    std::shared_ptr<State> mine = *st;
    auto notify = [](void* p) {
      auto* held = static_cast<std::shared_ptr<State>*>(p);
      {
        std::lock_guard<std::mutex> lk((*held)->m);
        (*held)->done = true;
      }
      (*held)->cv.notify_all();
      delete held;
    };
    Var* vs[1] = {v};
    Push(static_cast<EngineCallback>(notify), st, vs, 1, nullptr, 0,
         /*priority=*/1, "WaitForVar", nullptr, /*internal=*/true);
    std::unique_lock<std::mutex> lk(mine->m);
    if (timeout_ms < 0) {
      mine->cv.wait(lk, [&] { return mine->done; });
      return true;
    }
    return mine->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                             [&] { return mine->done; });
  }

  bool WaitForAll(long long timeout_ms = -1) {
    if (naive_) return true;
    std::unique_lock<std::mutex> lk(all_m_);
    if (timeout_ms < 0) {
      all_cv_.wait(lk, [&] { return pending_.load() == 0; });
      return true;
    }
    return all_cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                            [&] { return pending_.load() == 0; });
  }

  // From now on no user callback runs; internal ones (WaitForVar's
  // notification) still do, and every op still completes.
  void Shutdown() { stopping_.store(true); }

  uint64_t Version(Var* v) {
    std::lock_guard<std::mutex> lk(v->m);
    return v->version;
  }

  void SetProfiling(bool on) { profiling_.store(on); }

  // JSON string escaping for operator hints: quotes, backslashes and
  // control bytes would otherwise corrupt the Chrome trace.
  static std::string JsonEscape(const std::string& s) {
    std::string out;
    out.reserve(s.size());
    for (unsigned char c : s) {
      switch (c) {
        case '"': out += "\\\""; break;
        case '\\': out += "\\\\"; break;
        case '\n': out += "\\n"; break;
        case '\r': out += "\\r"; break;
        case '\t': out += "\\t"; break;
        default:
          if (c < 0x20) {
            char buf[8];
            snprintf(buf, sizeof(buf), "\\u%04x", c);
            out += buf;
          } else {
            out += static_cast<char>(c);
          }
      }
    }
    return out;
  }

  int DumpProfile(const char* path) {
    std::lock_guard<std::mutex> lk(prof_m_);
    FILE* fp = fopen(path, "w");
    if (!fp) return -1;
    fputs("{\"traceEvents\":[\n", fp);
    for (size_t i = 0; i < records_.size(); ++i) {
      const ProfileRecord& r = records_[i];
      fprintf(fp,
              "{\"name\":\"%s\",\"cat\":\"engine\",\"ph\":\"X\","
              "\"ts\":%llu,\"dur\":%llu,\"pid\":0,\"tid\":%d}%s\n",
              JsonEscape(r.name).c_str(), (unsigned long long)r.start_us,
              (unsigned long long)(r.end_us - r.start_us), r.tid,
              i + 1 < records_.size() ? "," : "");
    }
    fputs("],\"displayTimeUnit\":\"ms\"}\n", fp);
    fclose(fp);
    return 0;
  }

 private:
  void ReleaseVar(Var* v) {
    {
      std::lock_guard<std::mutex> lk(vars_m_);
      all_vars_.erase(std::remove(all_vars_.begin(), all_vars_.end(), v),
                      all_vars_.end());
    }
    delete v;
  }

  static void Dedup(std::vector<Var*>* vs) {
    std::vector<Var*> out;
    for (Var* v : *vs)
      if (std::find(out.begin(), out.end(), v) == out.end())
        out.push_back(v);
    vs->swap(out);
  }

  // Returns true if the dependency is granted immediately.
  bool AppendRead(Var* v, Opr* op) {
    std::lock_guard<std::mutex> lk(v->m);
    if (!v->running_write && v->waiting.empty()) {
      v->running_reads++;
      return true;
    }
    v->waiting.emplace_back(op, false);
    return false;
  }

  bool AppendWrite(Var* v, Opr* op) {
    std::lock_guard<std::mutex> lk(v->m);
    if (!v->running_write && v->running_reads == 0 && v->waiting.empty()) {
      v->running_write = true;
      return true;
    }
    v->waiting.emplace_back(op, true);
    return false;
  }

  void CompleteRead(Var* v) {
    std::vector<Opr*> grant;
    {
      std::lock_guard<std::mutex> lk(v->m);
      v->running_reads--;
      ScheduleLocked(v, &grant);
    }
    for (Opr* o : grant) Satisfy(o);
  }

  void CompleteWrite(Var* v) {
    std::vector<Opr*> grant;
    {
      std::lock_guard<std::mutex> lk(v->m);
      v->running_write = false;
      v->version++;
      ScheduleLocked(v, &grant);
    }
    for (Opr* o : grant) Satisfy(o);
  }

  // Grant as many queued deps as the rules allow. Called with v->m held.
  void ScheduleLocked(Var* v, std::vector<Opr*>* grant) {
    while (!v->waiting.empty()) {
      auto [op, is_write] = v->waiting.front();
      if (is_write) {
        if (v->running_reads == 0 && !v->running_write) {
          v->running_write = true;
          v->waiting.pop_front();
          grant->push_back(op);
        }
        break;  // a running or just-granted write blocks everything behind
      }
      if (v->running_write) break;
      v->running_reads++;
      v->waiting.pop_front();
      grant->push_back(op);
    }
  }

  void Satisfy(Opr* op) {
    if (op->wait.fetch_sub(1) == 1) Enqueue(op);
  }

  void Enqueue(Opr* op) {
    {
      std::unique_lock<std::mutex> lk(qm_);
      if (op->priority > 0)
        prio_q_.push_back(op);
      else
        normal_q_.push_back(op);
    }
    qcv_.notify_one();
  }

  void WorkerLoop(int tid) {
    while (true) {
      Opr* op = nullptr;
      {
        std::unique_lock<std::mutex> lk(qm_);
        qcv_.wait(lk, [&] {
          return shutdown_ || !prio_q_.empty() || !normal_q_.empty();
        });
        if (shutdown_ && prio_q_.empty() && normal_q_.empty()) return;
        if (!prio_q_.empty()) {
          op = prio_q_.front();
          prio_q_.pop_front();
        } else {
          op = normal_q_.front();
          normal_q_.pop_front();
        }
      }
      uint64_t t0 = NowUs();
      if (op->fn && (op->internal || !stopping_.load())) op->fn(op->ctx);
      uint64_t t1 = NowUs();
      if (profiling_.load()) Record(op->name, t0, t1, tid);
      for (Var* v : op->const_vars) CompleteRead(v);
      for (Var* v : op->mutable_vars) CompleteWrite(v);
      if (op->delete_var) ReleaseVar(op->delete_var);
      delete op;
      if (pending_.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> lk(all_m_);
        all_cv_.notify_all();
      }
    }
  }

  void Record(const std::string& name, uint64_t t0, uint64_t t1, int tid) {
    std::lock_guard<std::mutex> lk(prof_m_);
    records_.push_back({name, t0, t1, tid});
  }

  bool naive_;
  std::mutex push_m_;
  std::vector<std::thread> workers_;
  std::mutex qm_;
  std::condition_variable qcv_;
  std::deque<Opr*> normal_q_, prio_q_;
  bool shutdown_ = false;

  std::atomic<int> pending_{0};
  std::mutex all_m_;
  std::condition_variable all_cv_;

  std::mutex vars_m_;
  std::vector<Var*> all_vars_;

  std::atomic<bool> stopping_{false};
  std::atomic<bool> profiling_{false};
  std::mutex prof_m_;
  std::vector<ProfileRecord> records_;
};

}  // namespace

extern "C" {

void* MXTPUTorchEngineCreate(int num_workers, int naive) {
  return new Engine(num_workers, naive != 0);
}

void MXTPUTorchEngineFree(void* eng) { delete static_cast<Engine*>(eng); }

void* MXTPUTorchEngineNewVar(void* eng) {
  return static_cast<Engine*>(eng)->NewVar();
}

void MXTPUTorchEngineDelVar(void* eng, void* var) {
  static_cast<Engine*>(eng)->DeleteVar(static_cast<Var*>(var));
}

unsigned long long MXTPUTorchEngineVarVersion(void* eng, void* var) {
  return static_cast<Engine*>(eng)->Version(static_cast<Var*>(var));
}

void MXTPUTorchEnginePushAsync(void* eng, void (*fn)(void*), void* ctx,
                               void** const_vars, int n_const,
                               void** mut_vars, int n_mut, int priority,
                               const char* name) {
  static_cast<Engine*>(eng)->Push(
      fn, ctx, reinterpret_cast<Var**>(const_vars), n_const,
      reinterpret_cast<Var**>(mut_vars), n_mut, priority, name);
}

// timeout_ms < 0: no bound.  Returns 1 when the wait completed.
int MXTPUTorchEngineWaitForVar(void* eng, void* var, long long timeout_ms) {
  return static_cast<Engine*>(eng)->WaitForVar(static_cast<Var*>(var),
                                               timeout_ms) ? 1 : 0;
}

int MXTPUTorchEngineWaitForAll(void* eng, long long timeout_ms) {
  return static_cast<Engine*>(eng)->WaitForAll(timeout_ms) ? 1 : 0;
}

void MXTPUTorchEngineShutdown(void* eng) {
  static_cast<Engine*>(eng)->Shutdown();
}

void MXTPUTorchEngineSetProfiling(void* eng, int on) {
  static_cast<Engine*>(eng)->SetProfiling(on != 0);
}

int MXTPUTorchEngineDumpProfile(void* eng, const char* path) {
  return static_cast<Engine*>(eng)->DumpProfile(path);
}

}  // extern "C"
