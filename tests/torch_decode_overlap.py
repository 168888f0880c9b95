"""Whether JPEG decodes overlap across threads: the port's decoder spends
most of a decode in C++ called through ctypes, which releases the
interpreter lock. Not a test; from the root of a checkout:

    python3 tests/torch_decode_overlap.py

Writes 4 JPEG maps of 2048 x 2048 (chip_smoke.map_jpeg: the albedo and
normal maps of procedural_test_maps(0, 2048), twice each), then prints,
for 2 rounds, the host ms of decoding them one after another against
4 threads, and of loading them through the registry one after another
against ``registry.load_async`` (the native scheduler)."""

import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.getcwd())


def main() -> int:
    import chip_smoke
    from sailor_tpu_torch.assets.registry import AssetRegistry, load_async
    from sailor_tpu_torch.scenes import procedural_test_maps
    from sailor_tpu_torch.utils import jpeg

    datas = [chip_smoke.map_jpeg(m) for m in procedural_test_maps(0, 2048)[:2]] * 2
    jpeg.decode_jpeg(datas[0])  # builds the library
    with tempfile.TemporaryDirectory() as folder:
        paths = []
        for i, data in enumerate(datas):
            paths.append(os.path.join(folder, f"map{i}.jpg"))
            with open(paths[-1], "wb") as f:
                f.write(data)
        for rnd in range(2):
            t0 = time.perf_counter()
            for d in datas:
                jpeg.decode_jpeg(d)
            seq = time.perf_counter() - t0
            with ThreadPoolExecutor(4) as ex:
                t0 = time.perf_counter()
                list(ex.map(jpeg.decode_jpeg, datas))
                par = time.perf_counter() - t0
            reg = AssetRegistry(folder)
            t0 = time.perf_counter()
            for p in paths:
                reg.load(p)
            sync = time.perf_counter() - t0
            reg = AssetRegistry(folder)
            t0 = time.perf_counter()
            for h in [load_async(reg, p) for p in paths]:
                h.wait(300)
            asy = time.perf_counter() - t0
            print(f"round {rnd + 1}: decode 4 x 2048 JPEG sequential {seq * 1e3:.1f} ms, "
                  f"4 threads {par * 1e3:.1f} ms ({seq / par:.2f}x); registry load "
                  f"{sync * 1e3:.1f} ms, load_async {asy * 1e3:.1f} ms ({sync / asy:.2f}x) "
                  f"on {os.cpu_count()} CPUs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
