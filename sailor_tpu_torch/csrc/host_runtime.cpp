// Host runtime of the port: the arena, pool and multi-pool allocators and the
// task scheduler with thread classes and dependency lists.
//
// A copy of those sections of the JAX package's native/sailor_native.cpp
// (Runtime/Tasks/Scheduler.h and Runtime/Memory analogs), with the entry
// points renamed sailor_torch_* and the same logic, so that the same
// sequence of allocations gives the same occupancy stats. Two changes: a
// submit returns its own task's id (the reference's can return another
// thread's), and the waits have timed forms. The port keeps its
// own copy: it loads no library of the JAX package. kernels/host_lib.py
// builds it at first use with the system C++ compiler (-pthread) and
// native_bridge.py loads it with ctypes; it is host code only.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Arena allocator (Runtime/Memory/HeapAllocator.h analog: page-chained bump
// arena with O(1) reset; feeds task payloads and scratch buffers).
// ---------------------------------------------------------------------------

struct Arena {
    std::vector<char*> pages;
    size_t page_size;
    size_t offset = 0;  // within current page
    std::mutex mu;
};

void* sailor_torch_arena_create(size_t page_size) {
    auto* a = new Arena();
    a->page_size = page_size ? page_size : (1u << 20);
    a->pages.push_back(new char[a->page_size]);
    return a;
}

void* sailor_torch_arena_alloc(void* arena, size_t size, size_t align) {
    auto* a = static_cast<Arena*>(arena);
    std::lock_guard<std::mutex> lock(a->mu);
    if (align == 0) align = 16;
    size_t off = (a->offset + align - 1) & ~(align - 1);
    if (off + size > a->page_size) {
        size_t psz = std::max(a->page_size, size + align);
        a->pages.push_back(new char[psz]);
        a->offset = 0;
        off = 0;
    }
    char* p = a->pages.back() + off;
    a->offset = off + size;
    return p;
}

void sailor_torch_arena_reset(void* arena) {
    auto* a = static_cast<Arena*>(arena);
    std::lock_guard<std::mutex> lock(a->mu);
    for (size_t i = 1; i < a->pages.size(); ++i) delete[] a->pages[i];
    a->pages.resize(1);
    a->offset = 0;
}

void sailor_torch_arena_destroy(void* arena) {
    auto* a = static_cast<Arena*>(arena);
    for (char* p : a->pages) delete[] p;
    delete a;
}

// ---------------------------------------------------------------------------
// Pool / multi-pool allocators (Runtime/Memory/Memory.h TPoolAllocator /
// TMultiPoolAllocator analogs): fixed-size blocks carved from pages with an
// intrusive free list, and a size-class router over pools. Occupancy stats
// feed the `stats.memory` console command (Renderer.cpp GPU-arena stats).
// ---------------------------------------------------------------------------

struct Pool {
    size_t block_size;
    size_t blocks_per_page;
    std::vector<char*> pages;
    void* free_list = nullptr;   // intrusive: first word of a free block
    size_t capacity = 0;         // total blocks
    size_t used = 0;             // live blocks
    std::mutex mu;
};

static void pool_grow(Pool* p) {
    size_t bs = p->block_size < sizeof(void*) ? sizeof(void*) : p->block_size;
    char* page = new char[bs * p->blocks_per_page];
    p->pages.push_back(page);
    for (size_t i = p->blocks_per_page; i-- > 0;) {
        void** blk = reinterpret_cast<void**>(page + i * bs);
        *blk = p->free_list;
        p->free_list = blk;
    }
    p->capacity += p->blocks_per_page;
}

void* sailor_torch_pool_create(size_t block_size, size_t blocks_per_page) {
    auto* p = new Pool();
    p->block_size = block_size ? block_size : 64;
    p->blocks_per_page = blocks_per_page ? blocks_per_page : 256;
    return p;
}

void* sailor_torch_pool_alloc(void* pool) {
    auto* p = static_cast<Pool*>(pool);
    std::lock_guard<std::mutex> lock(p->mu);
    if (!p->free_list) pool_grow(p);
    void** blk = static_cast<void**>(p->free_list);
    p->free_list = *blk;
    p->used++;
    return blk;
}

void sailor_torch_pool_free(void* pool, void* blk) {
    auto* p = static_cast<Pool*>(pool);
    std::lock_guard<std::mutex> lock(p->mu);
    *static_cast<void**>(blk) = p->free_list;
    p->free_list = blk;
    p->used--;
}

// out[0]=pages, out[1]=capacity blocks, out[2]=used blocks, out[3]=reserved bytes
void sailor_torch_pool_stats(void* pool, size_t* out) {
    auto* p = static_cast<Pool*>(pool);
    std::lock_guard<std::mutex> lock(p->mu);
    size_t bs = p->block_size < sizeof(void*) ? sizeof(void*) : p->block_size;
    out[0] = p->pages.size();
    out[1] = p->capacity;
    out[2] = p->used;
    out[3] = p->pages.size() * bs * p->blocks_per_page;
}

void sailor_torch_pool_destroy(void* pool) {
    auto* p = static_cast<Pool*>(pool);
    for (char* pg : p->pages) delete[] pg;
    delete p;
}

struct MultiPool {
    // size classes: 16, 32, 64, ... 65536 (12 classes); larger -> malloc
    static const int kClasses = 12;
    Pool* pools[kClasses];
    std::atomic<size_t> oversize_bytes{0};
};

static int mpool_class(size_t size) {
    size_t c = 16; int idx = 0;
    while (c < size && idx < MultiPool::kClasses) { c <<= 1; ++idx; }
    return idx < MultiPool::kClasses ? idx : -1;
}

void* sailor_torch_mpool_create() {
    auto* mp = new MultiPool();
    size_t c = 16;
    for (int i = 0; i < MultiPool::kClasses; ++i, c <<= 1)
        mp->pools[i] = static_cast<Pool*>(sailor_torch_pool_create(c, 4096 / (i + 1) + 16));
    return mp;
}

void* sailor_torch_mpool_alloc(void* mpool, size_t size) {
    auto* mp = static_cast<MultiPool*>(mpool);
    int idx = mpool_class(size);
    if (idx < 0) { mp->oversize_bytes += size; return new char[size]; }
    return sailor_torch_pool_alloc(mp->pools[idx]);
}

void sailor_torch_mpool_free(void* mpool, void* blk, size_t size) {
    auto* mp = static_cast<MultiPool*>(mpool);
    int idx = mpool_class(size);
    if (idx < 0) { mp->oversize_bytes -= size; delete[] static_cast<char*>(blk); return; }
    sailor_torch_pool_free(mp->pools[idx], blk);
}

// out[0]=total pages, out[1]=capacity blocks, out[2]=used blocks,
// out[3]=reserved bytes (incl. oversize)
void sailor_torch_mpool_stats(void* mpool, size_t* out) {
    auto* mp = static_cast<MultiPool*>(mpool);
    out[0] = out[1] = out[2] = out[3] = 0;
    for (int i = 0; i < MultiPool::kClasses; ++i) {
        size_t s[4];
        sailor_torch_pool_stats(mp->pools[i], s);
        out[0] += s[0]; out[1] += s[1]; out[2] += s[2]; out[3] += s[3];
    }
    out[3] += mp->oversize_bytes.load();
}

void sailor_torch_mpool_destroy(void* mpool) {
    auto* mp = static_cast<MultiPool*>(mpool);
    for (int i = 0; i < MultiPool::kClasses; ++i) sailor_torch_pool_destroy(mp->pools[i]);
    delete mp;
}

// ---------------------------------------------------------------------------
// Task scheduler (Runtime/Tasks/Scheduler.h analog).
// Thread classes mirror the reference's Main(2)/Worker(1)/Render(0)/RHI(3)
// affinities; tasks carry dependency lists (Join) and completion waits.
// ---------------------------------------------------------------------------

typedef void (*task_fn)(void*);

struct Task {
    uint64_t id;
    task_fn fn;
    void* arg;
    std::vector<uint64_t> deps;
    int thread_class;
};

struct Scheduler {
    std::vector<std::thread> workers;
    std::deque<Task> queue;                    // shared queue (class-filtered)
    std::unordered_map<uint64_t, bool> done;   // id -> completed
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable done_cv;
    std::atomic<uint64_t> next_id{1};
    std::atomic<int> active{0};
    bool stopping = false;

    bool deps_ready(const Task& t) {
        for (uint64_t d : t.deps) {
            auto it = done.find(d);
            if (it == done.end() || !it->second) return false;
        }
        return true;
    }

    void worker_loop(int thread_class) {
        for (;;) {
            Task task{};
            {
                std::unique_lock<std::mutex> lock(mu);
                cv.wait(lock, [&] {
                    if (stopping) return true;
                    for (auto& t : queue)
                        if ((t.thread_class == thread_class || t.thread_class < 0) &&
                            deps_ready(t))
                            return true;
                    return false;
                });
                if (stopping) return;
                for (auto it = queue.begin(); it != queue.end(); ++it) {
                    if ((it->thread_class == thread_class || it->thread_class < 0) &&
                        deps_ready(*it)) {
                        task = *it;
                        queue.erase(it);
                        break;
                    }
                }
                if (!task.fn) continue;
                active++;
            }
            task.fn(task.arg);
            {
                std::lock_guard<std::mutex> lock(mu);
                done[task.id] = true;
                active--;
            }
            cv.notify_all();
            done_cv.notify_all();
        }
    }
};

void* sailor_torch_scheduler_create(int num_workers) {
    auto* s = new Scheduler();
    if (num_workers <= 0)
        num_workers = std::max(2u, std::thread::hardware_concurrency());
    for (int i = 0; i < num_workers; ++i)
        s->workers.emplace_back([s] { s->worker_loop(1); });  // Worker class
    // one render-class + one rhi-class thread (reference thread taxonomy)
    s->workers.emplace_back([s] { s->worker_loop(0); });
    s->workers.emplace_back([s] { s->worker_loop(3); });
    return s;
}

uint64_t sailor_torch_scheduler_submit(void* sched, task_fn fn, void* arg,
                                 const uint64_t* deps, int ndeps,
                                 int thread_class) {
    auto* s = static_cast<Scheduler*>(sched);
    Task t;
    const uint64_t id = t.id = s->next_id++;
    t.fn = fn;
    t.arg = arg;
    t.thread_class = thread_class;
    for (int i = 0; i < ndeps; ++i) t.deps.push_back(deps[i]);
    {
        std::lock_guard<std::mutex> lock(s->mu);
        s->done[t.id] = false;
        s->queue.push_back(std::move(t));
    }
    s->cv.notify_all();
    // the reference returns s->next_id - 1 here, which a submit on another
    // thread may have moved on: the port returns the task's own id
    return id;
}

int sailor_torch_scheduler_is_done(void* sched, uint64_t id) {
    auto* s = static_cast<Scheduler*>(sched);
    std::lock_guard<std::mutex> lock(s->mu);
    auto it = s->done.find(id);
    return (it != s->done.end() && it->second) ? 1 : 0;
}

void sailor_torch_scheduler_wait(void* sched, uint64_t id) {
    auto* s = static_cast<Scheduler*>(sched);
    std::unique_lock<std::mutex> lock(s->mu);
    s->done_cv.wait(lock, [&] {
        auto it = s->done.find(id);
        return it != s->done.end() && it->second;
    });
}

void sailor_torch_scheduler_wait_idle(void* sched) {
    auto* s = static_cast<Scheduler*>(sched);
    std::unique_lock<std::mutex> lock(s->mu);
    s->done_cv.wait(lock, [&] { return s->queue.empty() && s->active == 0; });
}

// The port's additions: sailor_torch_scheduler_wait and _wait_idle with a
// limit of timeout_ms milliseconds; 1 when the wait ended, 0 at the limit.
int sailor_torch_scheduler_wait_for(void* sched, uint64_t id, int64_t timeout_ms) {
    auto* s = static_cast<Scheduler*>(sched);
    std::unique_lock<std::mutex> lock(s->mu);
    return s->done_cv.wait_for(lock, std::chrono::milliseconds(timeout_ms), [&] {
        auto it = s->done.find(id);
        return it != s->done.end() && it->second;
    }) ? 1 : 0;
}

int sailor_torch_scheduler_wait_idle_for(void* sched, int64_t timeout_ms) {
    auto* s = static_cast<Scheduler*>(sched);
    std::unique_lock<std::mutex> lock(s->mu);
    return s->done_cv.wait_for(lock, std::chrono::milliseconds(timeout_ms), [&] {
        return s->queue.empty() && s->active == 0;
    }) ? 1 : 0;
}

int sailor_torch_scheduler_num_pending(void* sched) {
    auto* s = static_cast<Scheduler*>(sched);
    std::lock_guard<std::mutex> lock(s->mu);
    return (int)s->queue.size() + s->active.load();
}

void sailor_torch_scheduler_destroy(void* sched) {
    auto* s = static_cast<Scheduler*>(sched);
    {
        std::lock_guard<std::mutex> lock(s->mu);
        s->stopping = true;
    }
    s->cv.notify_all();
    for (auto& w : s->workers) w.join();
    delete s;
}

}  // extern "C"
