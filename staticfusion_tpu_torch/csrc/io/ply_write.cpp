// Native binary-PLY writer for large surfel maps (Reconstruction::savePly
// counterpart, Reconstruction.cpp:358-457): filtering + packing + one write,
// without materializing a Python-side record array for multi-million-surfel
// maps.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Arrays are dense over capacity; valid[i] && conf[i] > threshold exported.
// Returns number of vertices written, or <0 on error.
long sf_write_ply(const char* path, long n, const float* pos,
                  const float* conf, const float* color, const float* normal,
                  const float* radius, const uint8_t* valid,
                  float conf_threshold) {
  long count = 0;
  for (long i = 0; i < n; i++)
    if (valid[i] && conf[i] > conf_threshold) count++;

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f,
          "ply\nformat binary_little_endian 1.0\n"
          "element vertex %ld\n"
          "property float x\nproperty float y\nproperty float z\n"
          "property uchar red\nproperty uchar green\nproperty uchar blue\n"
          "property float nx\nproperty float ny\nproperty float nz\n"
          "property float radius\nend_header\n",
          count);

  std::vector<uint8_t> rec(3 * 4 + 3 + 3 * 4 + 4);
  for (long i = 0; i < n; i++) {
    if (!(valid[i] && conf[i] > conf_threshold)) continue;
    uint8_t* p = rec.data();
    memcpy(p, &pos[i * 3], 12);
    p += 12;
    for (int c = 0; c < 3; c++) {
      float v = color[i * 3 + c] * 255.0f + 0.5f;
      p[c] = v < 0 ? 0 : (v > 255 ? 255 : uint8_t(v));
    }
    p += 3;
    float nrm[3] = {-normal[i * 3], -normal[i * 3 + 1], -normal[i * 3 + 2]};
    memcpy(p, nrm, 12);
    p += 12;
    memcpy(p, &radius[i], 4);
    fwrite(rec.data(), 1, rec.size(), f);
  }
  fclose(f);
  return count;
}

}  // extern "C"
