// Host runtime of complex_materials_renderer_tpu_torch: the OBJ parser,
// the binned-SAH threaded-BVH builder and the RLE Radiance .hdr writer.
//
// The port's own copy of the JAX package's native/cmr_native.cpp, with the
// same C ABI (cmr_parse_obj, cmr_build_bvh, cmr_write_hdr, cmr_free) and
// the same arithmetic, so both packages parse, build and write the same
// arrays and bytes. The reference's host layer is C++ (tinyobjloader for
// .obj parsing, the Vulkan driver's acceleration-structure builder,
// stb_image_write for .hdr output — reference main.cpp:141-148, :176-203,
// :386-390); this is its equivalent: a Wavefront OBJ parser with
// tinyobjloader-compatible semantics (fan triangulation, .mtl definition
// order material ids), a binned-SAH BVH builder emitting the threaded
// (preorder + miss-link) layout the BVH walk consumes, and an RLE .hdr
// writer.
//
// Fused multiply-adds. The JAX package's committed library was built with
// -march=native on a host with FMA, and GCC contracted five a*b+c there:
// the two in half_area, the SAH cost's sum, the split plane (exact either
// way: a product by 1/16) and the RGBE mantissa's +0.5. This copy is built
// with -ffp-contract=off and writes those that round differently as
// std::fma, so it gives that library's trees and bytes on any host.
//
// Built by native.py at first use (no Makefile); bound with ctypes. All
// returned buffers are malloc'd and released with cmr_free. A failed open,
// read or write returns -1 with errno set.

#include <sys/stat.h>

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <cmath>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

void cmr_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------------

static bool read_file(const char* path, std::string& out) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    struct stat st;
    if (fstat(fileno(f), &st) != 0 || S_ISDIR(st.st_mode)) {
        // glibc opens a directory for reading; its "size" is no file's.
        fclose(f);
        errno = EISDIR;
        return false;
    }
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    out.resize((size_t)n);
    size_t got = fread(&out[0], 1, (size_t)n, f);
    fclose(f);
    out.resize(got);
    return true;
}

static const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    return p;
}

static const char* next_line(const char* p, const char* end) {
    while (p < end && *p != '\n') p++;
    return p < end ? p + 1 : end;
}

// Trim trailing spaces/tabs/CR so material names match the Python parser
// and tinyobjloader ("usemtl glass \n" must resolve to "glass").
static const char* rtrim(const char* begin, const char* e) {
    while (e > begin && (e[-1] == ' ' || e[-1] == '\t' || e[-1] == '\r')) e--;
    return e;
}

static void parse_mtl_names(const std::string& dir, const char* name_begin,
                            const char* name_end,
                            std::vector<std::string>& names,
                            std::unordered_map<std::string, int>& ids) {
    std::string path = dir + std::string(name_begin, name_end);
    std::string text;
    if (!read_file(path.c_str(), text)) return;
    const char* p = text.data();
    const char* end = p + text.size();
    while (p < end) {
        p = skip_ws(p, end);
        if (end - p > 6 && strncmp(p, "newmtl", 6) == 0) {
            const char* q = skip_ws(p + 6, end);
            const char* e = q;
            while (e < end && *e != '\n' && *e != '\r') e++;
            std::string nm(q, rtrim(q, e));
            if (!ids.count(nm)) {
                ids[nm] = (int)names.size();
                names.push_back(nm);
            }
        }
        p = next_line(p, end);
    }
}

// Parse path -> vertices (V*3 float), triangle indices (T*3 int,
// fan-triangulated), per-triangle material ids (T int, -1 = none), and
// the material-name table ('\0'-joined, .mtl definition order).
int cmr_parse_obj(const char* path, float** out_verts, int* out_nverts,
                  int** out_indices, int* out_ntris, int** out_matids,
                  char** out_matnames, int* out_nmats) {
    std::string text;
    if (!read_file(path, text)) return -1;

    std::string dir(path);
    size_t slash = dir.find_last_of("/\\");
    dir = slash == std::string::npos ? std::string("") : dir.substr(0, slash + 1);

    std::vector<float> verts;
    std::vector<int> indices;
    std::vector<int> matids;
    std::vector<std::string> names;
    std::unordered_map<std::string, int> name_ids;
    int current_mat = -1;

    verts.reserve(1 << 16);
    indices.reserve(1 << 17);

    const char* p = text.data();
    const char* end = p + text.size();
    std::vector<int> face;
    face.reserve(8);

    while (p < end) {
        p = skip_ws(p, end);
        if (p >= end) break;
        if (p[0] == 'v' && p + 1 < end && (p[1] == ' ' || p[1] == '\t')) {
            char* q = nullptr;
            float x = strtof(p + 1, &q);
            float y = strtof(q, &q);
            float z = strtof(q, &q);
            verts.push_back(x);
            verts.push_back(y);
            verts.push_back(z);
        } else if (p[0] == 'f' && p + 1 < end && (p[1] == ' ' || p[1] == '\t')) {
            face.clear();
            const char* q = p + 1;
            const char* line_end = q;
            while (line_end < end && *line_end != '\n') line_end++;
            while (q < line_end) {
                q = skip_ws(q, line_end);
                if (q >= line_end) break;
                char* after = nullptr;
                long idx = strtol(q, &after, 10);
                if (after == q) break;
                q = after;
                // Skip /vt/vn suffixes.
                while (q < line_end && *q != ' ' && *q != '\t') q++;
                int vi = idx > 0 ? (int)idx - 1 : (int)(verts.size() / 3) + (int)idx;
                face.push_back(vi);
            }
            for (size_t k = 1; k + 1 < face.size(); k++) {
                indices.push_back(face[0]);
                indices.push_back(face[k]);
                indices.push_back(face[k + 1]);
                matids.push_back(current_mat);
            }
        } else if (end - p > 6 && strncmp(p, "usemtl", 6) == 0) {
            const char* q = skip_ws(p + 6, end);
            const char* e = q;
            while (e < end && *e != '\n' && *e != '\r') e++;
            std::string nm(q, rtrim(q, e));
            auto it = name_ids.find(nm);
            current_mat = it == name_ids.end() ? -1 : it->second;
        } else if (end - p > 6 && strncmp(p, "mtllib", 6) == 0) {
            const char* q = skip_ws(p + 6, end);
            const char* e = q;
            while (e < end && *e != '\n' && *e != '\r') e++;
            parse_mtl_names(dir, q, rtrim(q, e), names, name_ids);
        }
        p = next_line(p, end);
    }

    *out_nverts = (int)(verts.size() / 3);
    *out_ntris = (int)(indices.size() / 3);
    *out_nmats = (int)names.size();

    *out_verts = (float*)malloc(verts.size() * sizeof(float));
    memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
    *out_indices = (int*)malloc(indices.size() * sizeof(int));
    memcpy(*out_indices, indices.data(), indices.size() * sizeof(int));
    *out_matids = (int*)malloc(matids.size() * sizeof(int));
    memcpy(*out_matids, matids.data(), matids.size() * sizeof(int));

    size_t name_bytes = 1;
    for (auto& n : names) name_bytes += n.size() + 1;
    char* blob = (char*)malloc(name_bytes);
    char* w = blob;
    for (auto& n : names) {
        memcpy(w, n.c_str(), n.size() + 1);
        w += n.size() + 1;
    }
    *w = '\0';
    *out_matnames = blob;
    return 0;
}

// ---------------------------------------------------------------------------
// Binned-SAH BVH with threaded (preorder + miss link) flattening
// ---------------------------------------------------------------------------

struct BuildNode {
    float bmin[3], bmax[3];
    int first = -1, count = 0;     // leaf payload
    int child_a = -1, child_b = -1;  // interior children (build-array ids)
};

static inline float half_area(const float mn[3], const float mx[3]) {
    float dx = std::max(mx[0] - mn[0], 0.f);
    float dy = std::max(mx[1] - mn[1], 0.f);
    float dz = std::max(mx[2] - mn[2], 0.f);
    return std::fma(dz, dx, std::fma(dx, dy, dy * dz));
}

int cmr_build_bvh(const float* tris, int num_tris, int leaf_size,
                  float** out_bmin, float** out_bmax, int** out_left,
                  int** out_count, int** out_miss, int** out_right,
                  int** out_order, int* out_nodes) {
    if (num_tris <= 0) return -1;
    const int NUM_BINS = 16;

    std::vector<float> tmin(num_tris * 3), tmax(num_tris * 3), cent(num_tris * 3);
    for (int t = 0; t < num_tris; t++) {
        const float* v = tris + t * 9;
        for (int a = 0; a < 3; a++) {
            float lo = std::min(v[a], std::min(v[3 + a], v[6 + a]));
            float hi = std::max(v[a], std::max(v[3 + a], v[6 + a]));
            tmin[t * 3 + a] = lo;
            tmax[t * 3 + a] = hi;
            cent[t * 3 + a] = 0.5f * (lo + hi);
        }
    }

    std::vector<int> order(num_tris);
    for (int i = 0; i < num_tris; i++) order[i] = i;
    std::vector<int> out_order_v(num_tris);
    int out_cursor = 0;

    std::vector<BuildNode> nodes;
    nodes.reserve(num_tris / leaf_size * 2 + 4);

    struct Work { int node; int begin; int end; };
    std::vector<Work> stack;

    auto make_node = [&](int begin, int end_) {
        BuildNode n;
        for (int a = 0; a < 3; a++) { n.bmin[a] = 1e30f; n.bmax[a] = -1e30f; }
        for (int i = begin; i < end_; i++) {
            int t = order[i];
            for (int a = 0; a < 3; a++) {
                n.bmin[a] = std::min(n.bmin[a], tmin[t * 3 + a]);
                n.bmax[a] = std::max(n.bmax[a], tmax[t * 3 + a]);
            }
        }
        nodes.push_back(n);
        return (int)nodes.size() - 1;
    };

    int root = make_node(0, num_tris);
    stack.push_back({root, 0, num_tris});

    while (!stack.empty()) {
        Work w = stack.back();
        stack.pop_back();
        int n = w.end - w.begin;
        if (n <= leaf_size) {
            nodes[w.node].first = out_cursor;
            nodes[w.node].count = n;
            for (int i = 0; i < n; i++) out_order_v[out_cursor + i] = order[w.begin + i];
            out_cursor += n;
            continue;
        }

        // Centroid bounds + widest axis.
        float cmin[3] = {1e30f, 1e30f, 1e30f}, cmax[3] = {-1e30f, -1e30f, -1e30f};
        for (int i = w.begin; i < w.end; i++) {
            int t = order[i];
            for (int a = 0; a < 3; a++) {
                cmin[a] = std::min(cmin[a], cent[t * 3 + a]);
                cmax[a] = std::max(cmax[a], cent[t * 3 + a]);
            }
        }
        int axis = 0;
        float ext = cmax[0] - cmin[0];
        for (int a = 1; a < 3; a++)
            if (cmax[a] - cmin[a] > ext) { ext = cmax[a] - cmin[a]; axis = a; }

        int mid;
        if (ext <= 1e-12f) {
            mid = w.begin + n / 2;
        } else {
            float inv = NUM_BINS / ext;
            float bin_bmin[NUM_BINS][3], bin_bmax[NUM_BINS][3];
            int bin_count[NUM_BINS] = {0};
            for (int b = 0; b < NUM_BINS; b++)
                for (int a = 0; a < 3; a++) { bin_bmin[b][a] = 1e30f; bin_bmax[b][a] = -1e30f; }
            for (int i = w.begin; i < w.end; i++) {
                int t = order[i];
                int b = std::min((int)((cent[t * 3 + axis] - cmin[axis]) * inv), NUM_BINS - 1);
                bin_count[b]++;
                for (int a = 0; a < 3; a++) {
                    bin_bmin[b][a] = std::min(bin_bmin[b][a], tmin[t * 3 + a]);
                    bin_bmax[b][a] = std::max(bin_bmax[b][a], tmax[t * 3 + a]);
                }
            }
            // Suffix sweep.
            float rmin[NUM_BINS][3], rmax[NUM_BINS][3];
            int rcount[NUM_BINS];
            for (int a = 0; a < 3; a++) { rmin[NUM_BINS - 1][a] = bin_bmin[NUM_BINS - 1][a]; rmax[NUM_BINS - 1][a] = bin_bmax[NUM_BINS - 1][a]; }
            rcount[NUM_BINS - 1] = bin_count[NUM_BINS - 1];
            for (int b = NUM_BINS - 2; b >= 0; b--) {
                rcount[b] = rcount[b + 1] + bin_count[b];
                for (int a = 0; a < 3; a++) {
                    rmin[b][a] = std::min(bin_bmin[b][a], rmin[b + 1][a]);
                    rmax[b][a] = std::max(bin_bmax[b][a], rmax[b + 1][a]);
                }
            }
            // Prefix sweep + SAH.
            float lmin[3] = {1e30f, 1e30f, 1e30f}, lmax[3] = {-1e30f, -1e30f, -1e30f};
            int lcount = 0;
            float best_cost = 1e30f;
            int best_k = -1;
            for (int k = 0; k < NUM_BINS - 1; k++) {
                lcount += bin_count[k];
                for (int a = 0; a < 3; a++) {
                    lmin[a] = std::min(lmin[a], bin_bmin[k][a]);
                    lmax[a] = std::max(lmax[a], bin_bmax[k][a]);
                }
                if (lcount == 0 || rcount[k + 1] == 0) continue;
                float cost = std::fma(half_area(rmin[k + 1], rmax[k + 1]),
                                      (float)rcount[k + 1],
                                      half_area(lmin, lmax) * (float)lcount);
                if (cost < best_cost) { best_cost = cost; best_k = k; }
            }
            if (best_k < 0) {
                // All in one bin: median split on the axis.
                mid = w.begin + n / 2;
                std::nth_element(order.begin() + w.begin, order.begin() + mid,
                                 order.begin() + w.end, [&](int a_, int b_) {
                                     return cent[a_ * 3 + axis] < cent[b_ * 3 + axis];
                                 });
            } else {
                float split = cmin[axis] + (best_k + 1) * ext / NUM_BINS;
                auto it = std::partition(order.begin() + w.begin, order.begin() + w.end,
                                         [&](int t) { return cent[t * 3 + axis] < split; });
                mid = (int)(it - order.begin());
                if (mid == w.begin || mid == w.end) mid = w.begin + n / 2;
            }
        }

        int ca = make_node(w.begin, mid);
        int cb = make_node(mid, w.end);
        nodes[w.node].child_a = ca;
        nodes[w.node].child_b = cb;
        // Process left first so its leaf triangles are emitted first
        // (preorder contract shared with the Python builder).
        stack.push_back({cb, mid, w.end});
        stack.push_back({ca, w.begin, mid});
    }

    // Subtree sizes (build-array ids), iterative postorder.
    std::vector<int> size(nodes.size(), 1);
    {
        std::vector<std::pair<int, bool>> post{{root, false}};
        while (!post.empty()) {
            auto [id, processed] = post.back();
            post.pop_back();
            if (nodes[id].child_a < 0) continue;
            if (processed) {
                size[id] = 1 + size[nodes[id].child_a] + size[nodes[id].child_b];
            } else {
                post.push_back({id, true});
                post.push_back({nodes[id].child_a, false});
                post.push_back({nodes[id].child_b, false});
            }
        }
    }

    int n_out = (int)nodes.size();
    float* bmin = (float*)malloc(n_out * 3 * sizeof(float));
    float* bmax = (float*)malloc(n_out * 3 * sizeof(float));
    int* left = (int*)malloc(n_out * sizeof(int));
    int* count = (int*)malloc(n_out * sizeof(int));
    int* miss = (int*)malloc(n_out * sizeof(int));
    int* right = (int*)malloc(n_out * sizeof(int));

    // Preorder emit with miss links.
    {
        struct Emit { int id; int miss; };
        std::vector<Emit> es{{root, -1}};
        int cursor = 0;
        while (!es.empty()) {
            Emit e = es.back();
            es.pop_back();
            int idx = cursor++;
            const BuildNode& bn = nodes[e.id];
            for (int a = 0; a < 3; a++) {
                bmin[idx * 3 + a] = bn.bmin[a];
                bmax[idx * 3 + a] = bn.bmax[a];
            }
            miss[idx] = e.miss;
            if (bn.child_a < 0) {
                left[idx] = bn.first;
                count[idx] = bn.count;
                right[idx] = -1;
            } else {
                int left_index = idx + 1;
                int right_index = left_index + size[bn.child_a];
                left[idx] = left_index;
                right[idx] = right_index;
                count[idx] = 0;
                es.push_back({bn.child_b, e.miss});
                es.push_back({bn.child_a, right_index});
            }
        }
    }

    int* order_out = (int*)malloc(num_tris * sizeof(int));
    memcpy(order_out, out_order_v.data(), num_tris * sizeof(int));

    *out_bmin = bmin;
    *out_bmax = bmax;
    *out_left = left;
    *out_count = count;
    *out_miss = miss;
    *out_right = right;
    *out_order = order_out;
    *out_nodes = n_out;
    return 0;
}

// ---------------------------------------------------------------------------
// Radiance .hdr writer (adaptive RLE, stb-compatible output)
// ---------------------------------------------------------------------------

static void rgbe_encode(const float* rgb, unsigned char* out) {
    float m = std::max(rgb[0], std::max(rgb[1], rgb[2]));
    if (m < 1e-32f) {
        out[0] = out[1] = out[2] = out[3] = 0;
        return;
    }
    int e;
    float mant = frexpf(m, &e);
    float scale = mant * 256.0f / m;
    for (int c = 0; c < 3; c++) {
        float v = std::fma(rgb[c], scale, 0.5f);
        out[c] = (unsigned char)std::min(std::max(v, 0.0f), 255.0f);
    }
    out[3] = (unsigned char)(e + 128);
}

static void rle_channel(FILE* f, const unsigned char* data, int width) {
    int x = 0;
    while (x < width) {
        // Find a run of >= 3.
        int run_start = x;
        while (run_start < width) {
            int r = 1;
            while (run_start + r < width && r < 127 &&
                   data[run_start + r] == data[run_start])
                r++;
            if (r >= 3) break;
            run_start += r;
        }
        // Literals before the run.
        int lit = run_start - x;
        while (lit > 0) {
            int chunk = std::min(lit, 128);
            fputc(chunk, f);
            fwrite(data + x, 1, chunk, f);
            x += chunk;
            lit -= chunk;
        }
        if (run_start < width) {
            int r = 1;
            while (run_start + r < width && r < 127 &&
                   data[run_start + r] == data[run_start])
                r++;
            fputc(128 + r, f);
            fputc(data[run_start], f);
            x = run_start + r;
        }
    }
}

int cmr_write_hdr(const char* path, const float* rgb, int width, int height) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    fprintf(f, "#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n", height, width);

    std::vector<unsigned char> row(width * 4);
    std::vector<unsigned char> chan(width);
    for (int y = 0; y < height; y++) {
        for (int x = 0; x < width; x++)
            rgbe_encode(rgb + (y * width + x) * 3, &row[x * 4]);
        if (width < 8 || width > 32767) {
            fwrite(row.data(), 1, width * 4, f);
            continue;
        }
        unsigned char hdr[4] = {2, 2, (unsigned char)(width >> 8),
                                (unsigned char)(width & 0xFF)};
        fwrite(hdr, 1, 4, f);
        for (int c = 0; c < 4; c++) {
            for (int x = 0; x < width; x++) chan[x] = row[x * 4 + c];
            rle_channel(f, chan.data(), width);
        }
    }
    // A full disk or an I/O error shows only here.
    int failed = ferror(f);
    if (fclose(f) != 0 || failed) return -1;
    return 0;
}

}  // extern "C"
