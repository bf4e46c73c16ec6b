// Cell-list radius-graph builder (open boundary conditions).
//
// Native analog of the C-accelerated neighbor search the reference leans on
// (ASE neighborlist, hydragnn/preprocess/graph_samples_checks_and_updates.py
// :141-343 — SURVEY §2.3 item 10). The numpy/scipy path in
// data/neighbors.py is fine for molecules; at OC20-catalog scale (millions
// of samples, hundreds of atoms each) host-side preprocessing becomes the
// bottleneck and the O(27 * n * density) cell list wins.
//
// Contract (mirrors data/neighbors.radius_graph before the neighbor cap):
// all DIRECTED edges (sender j -> receiver i, i != j) with
// ||pos_i - pos_j|| <= radius. Edges are emitted receiver-major and
// sender-sorted within a receiver, a canonical order.
//
// Returns the edge count, or -(needed) when the caller's buffer is too
// small (caller retries with a bigger buffer).

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

long rg_open(const double* pos, long n, double radius,
             int32_t* senders, int32_t* receivers, long cap) {
    if (n <= 0 || radius <= 0.0) return 0;
    const double r2 = radius * radius;

    // bounding box
    double lo[3], hi[3];
    for (int d = 0; d < 3; ++d) { lo[d] = pos[d]; hi[d] = pos[d]; }
    for (long i = 1; i < n; ++i)
        for (int d = 0; d < 3; ++d) {
            const double v = pos[3 * i + d];
            if (v < lo[d]) lo[d] = v;
            if (v > hi[d]) hi[d] = v;
        }

    // grid of cells with side >= radius
    long nc[3];
    for (int d = 0; d < 3; ++d) {
        nc[d] = (long)std::floor((hi[d] - lo[d]) / radius) + 1;
        if (nc[d] < 1) nc[d] = 1;
    }
    const long ncells = nc[0] * nc[1] * nc[2];

    auto cell_of = [&](long i, long out[3]) {
        for (int d = 0; d < 3; ++d) {
            long c = (long)std::floor((pos[3 * i + d] - lo[d]) / radius);
            if (c < 0) c = 0;
            if (c >= nc[d]) c = nc[d] - 1;
            out[d] = c;
        }
    };
    auto flat = [&](const long c[3]) {
        return (c[0] * nc[1] + c[1]) * nc[2] + c[2];
    };

    // counting sort of atoms into cells
    std::vector<long> count(ncells + 1, 0);
    std::vector<long> acell(n);
    for (long i = 0; i < n; ++i) {
        long c[3];
        cell_of(i, c);
        acell[i] = flat(c);
        count[acell[i] + 1]++;
    }
    for (long c = 0; c < ncells; ++c) count[c + 1] += count[c];
    std::vector<long> order(n);
    {
        std::vector<long> cursor(count.begin(), count.end() - 1);
        for (long i = 0; i < n; ++i) order[cursor[acell[i]]++] = i;
    }

    long m = 0;
    std::vector<int32_t> nbr;  // senders of receiver i, gathered then sorted
    nbr.reserve(64);
    for (long i = 0; i < n; ++i) {
        long c[3];
        cell_of(i, c);
        nbr.clear();
        for (long dx = -1; dx <= 1; ++dx) {
            const long cx = c[0] + dx;
            if (cx < 0 || cx >= nc[0]) continue;
            for (long dy = -1; dy <= 1; ++dy) {
                const long cy = c[1] + dy;
                if (cy < 0 || cy >= nc[1]) continue;
                for (long dz = -1; dz <= 1; ++dz) {
                    const long cz = c[2] + dz;
                    if (cz < 0 || cz >= nc[2]) continue;
                    const long cc[3] = {cx, cy, cz};
                    const long f = flat(cc);
                    for (long k = count[f]; k < count[f + 1]; ++k) {
                        const long j = order[k];
                        if (j == i) continue;
                        double d2 = 0.0;
                        for (int d = 0; d < 3; ++d) {
                            const double diff = pos[3 * i + d] - pos[3 * j + d];
                            d2 += diff * diff;
                        }
                        if (d2 <= r2) nbr.push_back((int32_t)j);
                    }
                }
            }
        }
        // canonical order: senders ascending within each receiver
        for (size_t a = 1; a < nbr.size(); ++a) {  // insertion sort, small lists
            int32_t v = nbr[a];
            size_t b = a;
            while (b > 0 && nbr[b - 1] > v) { nbr[b] = nbr[b - 1]; --b; }
            nbr[b] = v;
        }
        if (m + (long)nbr.size() > cap) {
            // count the rest so the caller can size the retry buffer
            long needed = m + (long)nbr.size();
            for (long i2 = i + 1; i2 < n; ++i2) {
                long c2[3];
                cell_of(i2, c2);
                for (long dx = -1; dx <= 1; ++dx) {
                    const long cx = c2[0] + dx;
                    if (cx < 0 || cx >= nc[0]) continue;
                    for (long dy = -1; dy <= 1; ++dy) {
                        const long cy = c2[1] + dy;
                        if (cy < 0 || cy >= nc[1]) continue;
                        for (long dz = -1; dz <= 1; ++dz) {
                            const long cz = c2[2] + dz;
                            if (cz < 0 || cz >= nc[2]) continue;
                            const long cc[3] = {cx, cy, cz};
                            const long f = flat(cc);
                            for (long k = count[f]; k < count[f + 1]; ++k) {
                                const long j = order[k];
                                if (j == i2) continue;
                                double d2 = 0.0;
                                for (int d = 0; d < 3; ++d) {
                                    const double diff =
                                        pos[3 * i2 + d] - pos[3 * j + d];
                                    d2 += diff * diff;
                                }
                                if (d2 <= r2) ++needed;
                            }
                        }
                    }
                }
            }
            return -needed;
        }
        for (int32_t s : nbr) {
            senders[m] = s;
            receivers[m] = (int32_t)i;
            ++m;
        }
    }
    return m;
}

}  // extern "C"
