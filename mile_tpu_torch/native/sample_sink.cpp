// Asynchronous sample sink: background-threaded persistence of MCMC draws
// (the port's copy of mile_tpu/native/sample_sink.cpp, same C API and files).
//
// The sampling runtime hands whole host chunks (n_chains, block, dim) to
// this sink, which copies them onto a job queue and returns at once; a
// writer thread appends each chain's rows to chain_{c}/samples.bin, beside
// a chain_{c}/samples.meta that records the row width. Python never waits
// on disk.
//
// Build: g++ -O2 -shared -fPIC -pthread sample_sink.cpp -o libsample_sink.so
//
// C API (ctypes-friendly):
//   void*  sink_create(const char* dir, long n_chains, long dim);
//   int    sink_write(void* h, const float* data, long n_chains,
//                     long block, long dim, long start);
//   long   sink_rows_written(void* h);   // rows per chain written so far
//   int    sink_flush(void* h);
//   void   sink_destroy(void* h);
//
// sink_flush returns once every queued job is on disk: it waits for the
// job the writer holds as well as for the queue (the reference's flush
// returns as soon as the queue is empty, while the last job may still be
// being written, so its row count could lag).

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <vector>

namespace {

struct Job {
    std::vector<float> data;  // (n_chains, block, dim) row-major
    long n_chains, block, dim;
};

struct Sink {
    std::string dir;
    long n_chains = 0;
    long dim = 0;
    std::vector<FILE*> files;
    std::deque<Job> queue;
    bool writing = false;  // the writer holds a job (guarded by mu)
    std::mutex mu;
    std::condition_variable cv_push, cv_drain;
    std::thread worker;
    std::atomic<long> rows_written{0};
    std::atomic<bool> failed{false};
    bool stop = false;

    void run() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lock(mu);
                cv_push.wait(lock, [&] { return stop || !queue.empty(); });
                if (queue.empty()) return;  // stop, and nothing left
                job = std::move(queue.front());
                queue.pop_front();
                writing = true;
            }
            const long per_chain = job.block * job.dim;
            for (long c = 0; c < job.n_chains && c < (long)files.size(); ++c) {
                if (files[c]) {
                    size_t n = fwrite(job.data.data() + c * per_chain,
                                      sizeof(float), per_chain, files[c]);
                    if ((long)n != per_chain) failed = true;
                } else {
                    failed = true;
                }
            }
            rows_written += job.block;
            {
                std::lock_guard<std::mutex> lock(mu);
                writing = false;
            }
            cv_drain.notify_all();
        }
    }
};

}  // namespace

extern "C" {

void* sink_create(const char* dir, long n_chains, long dim) {
    auto* s = new Sink();
    s->dir = dir;
    s->n_chains = n_chains;
    s->dim = dim;
    ::mkdir(dir, 0755);
    for (long c = 0; c < n_chains; ++c) {
        std::string chain_dir = s->dir + "/chain_" + std::to_string(c);
        ::mkdir(chain_dir.c_str(), 0755);
        FILE* f = fopen((chain_dir + "/samples.bin").c_str(), "wb");
        s->files.push_back(f);
        // record the row width for the loader
        FILE* meta = fopen((chain_dir + "/samples.meta").c_str(), "w");
        if (meta) {
            fprintf(meta, "{\"dim\": %ld, \"dtype\": \"float32\"}\n", dim);
            fclose(meta);
        }
    }
    s->worker = std::thread([s] { s->run(); });
    return s;
}

int sink_write(void* h, const float* data, long n_chains, long block,
               long dim, long /*start*/) {
    auto* s = static_cast<Sink*>(h);
    if (!s || s->failed) return -1;
    Job job;
    job.n_chains = n_chains;
    job.block = block;
    job.dim = dim;
    job.data.assign(data, data + n_chains * block * dim);
    {
        std::lock_guard<std::mutex> lock(s->mu);
        s->queue.push_back(std::move(job));
    }
    s->cv_push.notify_one();
    return 0;
}

long sink_rows_written(void* h) {
    auto* s = static_cast<Sink*>(h);
    return s ? s->rows_written.load() : -1;
}

int sink_flush(void* h) {
    auto* s = static_cast<Sink*>(h);
    if (!s) return -1;
    {
        std::unique_lock<std::mutex> lock(s->mu);
        s->cv_drain.wait(lock,
                         [&] { return s->queue.empty() && !s->writing; });
    }
    for (FILE* f : s->files)
        if (f && fflush(f) != 0) s->failed = true;
    return s->failed ? -1 : 0;
}

void sink_destroy(void* h) {
    auto* s = static_cast<Sink*>(h);
    if (!s) return;
    sink_flush(h);
    {
        std::lock_guard<std::mutex> lock(s->mu);
        s->stop = true;
    }
    s->cv_push.notify_all();
    if (s->worker.joinable()) s->worker.join();
    for (FILE* f : s->files)
        if (f) fclose(f);
    delete s;
}

}  // extern "C"
