// Host-side mesh preprocessing in C++ for the PyTorch port, bound with
// ctypes (softmac_tpu_torch/native/__init__.py builds it with g++ at first
// use). Two entry points with a plain C interface:
//
// - softmac_process_faces: the per-face breadth-first adjacency with
//   orientation-flip flags that the cloth's penetration tracing reads
//   (soft_cloth/engine/primitive/process_faces.py); minutes in Python for
//   a few hundred faces, milliseconds here.
// - softmac_parse_obj: a Wavefront OBJ triangle parser (v / f lines, fan
//   triangulation, negative indices), two passes: call with null outputs
//   for the counts.
//
// Both give the arrays of the package's Python bodies
// (cloth_contact.process_faces_plain, meshio.load_obj_plain).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <algorithm>
#include <deque>
#include <map>
#include <utility>
#include <vector>

extern "C" {

// faces: (n_faces, 3) int32. Outputs:
//   neighbors_out: (n_faces, n_neighbors) int32, -1 padded
//   dirs_out:      (n_faces, n_neighbors) int8 orientation-flip flags
// Returns 0 on success.
int softmac_process_faces(const int32_t* faces, int n_faces, int n_neighbors,
                          int32_t* neighbors_out, int8_t* dirs_out) {
    using Edge = std::pair<int32_t, int32_t>;
    std::map<Edge, std::vector<int32_t>> edge_faces;
    for (int i = 0; i < n_faces; ++i) {
        for (int j = 0; j < 3; ++j) {
            int32_t v1 = faces[i * 3 + j];
            int32_t v2 = faces[i * 3 + (j + 1) % 3];
            Edge e{std::min(v1, v2), std::max(v1, v2)};
            edge_faces[e].push_back(i);
        }
    }

    std::vector<uint8_t> visited(n_faces);
    for (int i = 0; i < n_faces; ++i) {
        std::fill(visited.begin(), visited.end(), 0);
        std::deque<std::pair<int32_t, bool>> queue;
        queue.emplace_back(i, false);
        int found = 0;  // excluding self
        bool self_done = false;
        while (!queue.empty() && found < n_neighbors) {
            auto [cur, inv] = queue.front();
            queue.pop_front();
            if (visited[cur]) continue;
            visited[cur] = 1;
            if (self_done || cur != i) {
                neighbors_out[(int64_t)i * n_neighbors + found] = cur;
                dirs_out[(int64_t)i * n_neighbors + found] = inv ? 1 : 0;
                ++found;
            }
            if (cur == i) self_done = true;
            for (int j = 0; j < 3; ++j) {
                int32_t v1 = faces[cur * 3 + j];
                int32_t v2 = faces[cur * 3 + (j + 1) % 3];
                Edge e{std::min(v1, v2), std::max(v1, v2)};
                for (int32_t f : edge_faces[e]) {
                    if (f == cur || visited[f]) continue;
                    bool inv_new = inv;
                    for (int k = 0; k < 3; ++k) {
                        if (faces[f * 3 + k] == v1 &&
                            faces[f * 3 + (k + 1) % 3] == v2) {
                            inv_new = !inv;
                            break;
                        }
                    }
                    queue.emplace_back(f, inv_new);
                }
            }
        }
        for (; found < n_neighbors; ++found) {
            neighbors_out[(int64_t)i * n_neighbors + found] = -1;
            dirs_out[(int64_t)i * n_neighbors + found] = 0;
        }
    }
    return 0;
}

// Minimal OBJ triangle-mesh parser (v / f lines, fan triangulation,
// negative indices). Two-pass C ABI: call with null outputs to get counts,
// then with outputs of those sizes. Returns 0, 1 (unreadable) or 2 (more
// than the outputs hold).
int softmac_parse_obj(const char* path, double* verts_out, int32_t* faces_out,
                      int64_t* n_verts, int64_t* n_faces) {
    FILE* fp = fopen(path, "r");
    if (!fp) return 1;
    std::vector<double> verts;
    std::vector<int32_t> faces;
    char line[4096];
    while (fgets(line, sizeof(line), fp)) {
        if (line[0] == 'v' && line[1] == ' ') {
            double x, y, z;
            if (sscanf(line + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
                verts.push_back(x); verts.push_back(y); verts.push_back(z);
            }
        } else if (line[0] == 'f' && line[1] == ' ') {
            std::vector<int32_t> idx;
            char* tok = strtok(line + 2, " \t\r\n");
            while (tok) {
                long v = strtol(tok, nullptr, 10);
                int64_t nv = (int64_t)(verts.size() / 3);
                idx.push_back((int32_t)(v > 0 ? v - 1 : nv + v));
                tok = strtok(nullptr, " \t\r\n");
            }
            for (size_t k = 1; k + 1 < idx.size(); ++k) {
                faces.push_back(idx[0]);
                faces.push_back(idx[k]);
                faces.push_back(idx[k + 1]);
            }
        }
    }
    fclose(fp);
    // with outputs, *n_verts and *n_faces hold their capacities (the first
    // pass's counts): a file that grew in between is refused
    int64_t nv = (int64_t)(verts.size() / 3), nf = (int64_t)(faces.size() / 3);
    if ((verts_out && nv > *n_verts) || (faces_out && nf > *n_faces)) return 2;
    *n_verts = nv;
    *n_faces = nf;
    if (verts_out) memcpy(verts_out, verts.data(), verts.size() * sizeof(double));
    if (faces_out) memcpy(faces_out, faces.data(), faces.size() * sizeof(int32_t));
    return 0;
}

}  // extern "C"
