"""key=value settings-file parser with per-mode schema validation.

The port's copy of imageencoder_tpu/utils/config.py.

Parity with dc::ConfigReader (ConfigReader.cpp):
  * one ``key=value`` per line, no sections or comments (:75-122),
  * CR/LF stripped, empty lines skipped, duplicate keys rejected (:111-115),
  * image schema: exactly the 8 keys rawfile, encfile, decfile, rle,
    quantfile, width, height, logfile (ConfigReader.hpp:14-24, .cpp:185-207),
  * video encoder schema adds gop + merange; video decoder needs only
    encfile, decfile, motioncompensation (ConfigReader.hpp:41-53).

Mode detection mirrors main.cpp:34-52: a config is an image job iff it
validates for image and not for video, and vice versa.
"""

from __future__ import annotations

IMAGE_KEYS = ("rawfile", "encfile", "decfile", "rle", "quantfile",
              "width", "height", "logfile")
VIDEO_ENCODER_KEYS = ("rawfile", "encfile", "rle", "quantfile",
                      "width", "height", "gop", "merange")
VIDEO_DECODER_KEYS = ("encfile", "decfile", "motioncompensation")
ALL_VIDEO_KEYS = IMAGE_KEYS + ("gop", "merange", "motioncompensation")


class ConfigReader:
    def __init__(self) -> None:
        self.values: dict[str, str] = {}
        self.error: str = ""

    def read(self, path: str) -> bool:
        self.values.clear()
        try:
            with open(path, "r") as f:
                text = f.read()
        except OSError:
            self.error = "Can't open file"
            return False
        for raw_line in text.split("\n"):
            line = raw_line.rstrip("\r\n")
            if not line:
                continue
            if "=" not in line:
                self.error = "Can't find '=' in line"
                return False
            key, _, value = line.partition("=")
            if not key:
                self.error = "Detected an empty key"
                return False
            if key in self.values:
                self.error = f"Key '{key}' was found more than once!"
                return False
            self.values[key] = value
        return True

    def get(self, key: str, default: str = "") -> str:
        return self.values.get(key, default)

    def _has_all(self, keys) -> bool:
        missing = [k for k in keys if k not in self.values]
        if missing:
            self.error = f"Missing keys: {', '.join(missing)}"
            return False
        return True

    def verify_for_image(self) -> bool:
        """Exact image schema: all 8 keys, no video keys (ConfigReader.cpp:185-207)."""
        if not self._has_all(IMAGE_KEYS):
            return False
        extra = set(self.values) - set(IMAGE_KEYS)
        if extra:
            self.error = f"Unexpected keys for image job: {sorted(extra)}"
            return False
        return True

    def verify_for_video(self, encoder: bool) -> bool:
        keys = VIDEO_ENCODER_KEYS if encoder else VIDEO_DECODER_KEYS
        if not self._has_all(keys):
            return False
        extra = set(self.values) - set(ALL_VIDEO_KEYS)
        if extra:
            self.error = f"Unexpected keys for video job: {sorted(extra)}"
            return False
        # A config with no video-only keys at all is an image config.
        if not (set(self.values) & {"gop", "merange", "motioncompensation"}):
            self.error = "No video keys present"
            return False
        return True

    def detect_mode(self) -> str:
        """'image' | 'video-encode' | 'video-decode' | 'invalid' (main.cpp:34-52)."""
        is_image = self.verify_for_image()
        is_venc = self.verify_for_video(True)
        is_vdec = self.verify_for_video(False)
        if is_image and not (is_venc or is_vdec):
            return "image"
        if (is_venc or is_vdec) and not is_image:
            return "video-encode" if is_venc else "video-decode"
        return "invalid"
