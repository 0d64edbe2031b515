// JPEG decoding on the card with nvJPEG, for mapfree_tpu_torch/data/jpeg.py.
//
// The card's counterpart of the host decoder native/decoder.cpp
// (decode_resize_batch), not of a TPU kernel: the machine with the card has
// no libjpeg, cv2 or PIL, and the CUDA toolkit ships nvJPEG. This file holds
// no kernel of its own. It exports plain C functions over nvJPEG's
// single-image API, loaded with ctypes:
//
//   jd_create                           one library handle (thread-safe)
//   jd_state_create                     one decode state per host thread
//   jd_image_info                       the frame's width, height, components
//   jd_decode_rgbi                      one frame to interleaved RGB uint8 in
//                                       device memory, on the caller's stream,
//                                       waiting for it
//   jd_library_path, jd_version         which libnvjpeg was loaded
//
// The handle and the states live as long as the process. Every function
// returns nvJPEG's status (0 is success) or a string. The
// resize to the model's size and the packing to float, uint8 or planar
// YUV420 are torch operations in data/jpeg.py, with the arithmetic of
// native/decoder.cpp::resize_normalize and ops/image.py::yuv420_pack_host.
//
// What bounds it: nvJPEG's default (hybrid) backend decodes the Huffman
// stream on the host and the inverse DCT, chroma upsampling and colour
// conversion on the card, so a batch is bound by the host's entropy decode;
// data/jpeg.py runs several host threads, each with a state of its own.

#include <cuda_runtime.h>
#include <dlfcn.h>
#include <nvjpeg.h>

#include <cstring>

extern "C" {

int jd_create(void** handle) {
  nvjpegHandle_t h = nullptr;
  const nvjpegStatus_t status = nvjpegCreateSimple(&h);
  *handle = h;
  return static_cast<int>(status);
}

int jd_state_create(void* handle, void** state) {
  nvjpegJpegState_t s = nullptr;
  const nvjpegStatus_t status =
      nvjpegJpegStateCreate(static_cast<nvjpegHandle_t>(handle), &s);
  *state = s;
  return static_cast<int>(status);
}

// The frame's size from its headers alone: width and height of the first
// (luma) component, and the number of components.
int jd_image_info(void* handle, const unsigned char* data, size_t length,
                  int* width, int* height, int* components) {
  int n = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  const nvjpegStatus_t status =
      nvjpegGetImageInfo(static_cast<nvjpegHandle_t>(handle), data, length, &n,
                         &subsampling, widths, heights);
  *width = widths[0];
  *height = heights[0];
  *components = n;
  return static_cast<int>(status);
}

// Decode one frame into ``dst``: interleaved RGB uint8, ``pitch`` bytes a
// row, in device memory, on ``stream``; nvJPEG converts a grayscale frame
// to RGB itself. Returns once the frame is in ``dst``: the hybrid backend
// stages the frame's Huffman-decoded coefficients in the state's host
// buffers and copies them to the card on ``stream``, so the state may take
// its next frame only after that copy. Without the wait, a stream still
// busy with earlier work let the next frame overwrite the staged
// coefficients (frames decoded beside a forward came out different). A
// CUDA error in the wait returns 1000 + its cudaError_t.
int jd_decode_rgbi(void* handle, void* state, const unsigned char* data,
                   size_t length, unsigned char* dst, size_t pitch,
                   void* stream) {
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.channel[0] = dst;
  image.pitch[0] = pitch;
  const nvjpegStatus_t status = nvjpegDecode(
      static_cast<nvjpegHandle_t>(handle),
      static_cast<nvjpegJpegState_t>(state), data, length,
      NVJPEG_OUTPUT_RGBI, &image, static_cast<cudaStream_t>(stream));
  if (status != NVJPEG_STATUS_SUCCESS) return static_cast<int>(status);
  const cudaError_t err = cudaStreamSynchronize(static_cast<cudaStream_t>(stream));
  return err == cudaSuccess ? 0 : 1000 + static_cast<int>(err);
}

// The file the dynamic loader took nvJPEG from.
const char* jd_library_path() {
  Dl_info info;
  if (dladdr(reinterpret_cast<void*>(&nvjpegCreateSimple), &info) &&
      info.dli_fname != nullptr) {
    return info.dli_fname;
  }
  return "";
}

int jd_version(int* major, int* minor, int* patch) {
  int status = static_cast<int>(nvjpegGetProperty(MAJOR_VERSION, major));
  if (status == 0) status = static_cast<int>(nvjpegGetProperty(MINOR_VERSION, minor));
  if (status == 0) status = static_cast<int>(nvjpegGetProperty(PATCH_LEVEL, patch));
  return status;
}

}  // extern "C"
