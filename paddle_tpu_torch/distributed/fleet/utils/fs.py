"""``fleet.utils.fs``: filesystem clients for checkpoint and data staging,
the port of ``paddle_tpu/distributed/fleet/utils/fs.py`` (standard
library only).

``LocalFS`` is fully functional. ``HDFSClient`` keeps the API surface
but needs a hadoop client binary, which this build does not ship:
constructing one raises with that explanation (PARITY.md)."""

from __future__ import annotations

import os
import shutil

from ....utils.retry import retry_call

__all__ = ["LocalFS", "HDFSClient", "FSFileExistsError",
           "FSFileNotExistsError"]


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class LocalFS:
    """Local filesystem with the upstream FS client API. Data-moving
    operations retry transient I/O errors (EIO/EAGAIN/ENOSPC...) with
    bounded exponential backoff — checkpoint staging over a flaky
    mount should not die on a single blip."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            (dirs if os.path.isdir(os.path.join(fs_path, name))
             else files).append(name)
        return dirs, files

    def mkdirs(self, fs_path):
        retry_call(os.makedirs, fs_path, exist_ok=True)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        def _touch():
            with open(fs_path, "a"):
                pass
        retry_call(_touch)

    def delete(self, fs_path):
        if not self.is_exist(fs_path):
            return
        if self.is_dir(fs_path):
            shutil.rmtree(fs_path)
        else:
            os.remove(fs_path)

    def need_upload_download(self):
        return False

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def mv(self, src_path, dst_path, overwrite=False, test_exists=True):
        if test_exists and not self.is_exist(src_path):
            raise FSFileNotExistsError(src_path)
        if self.is_exist(dst_path):
            if not overwrite:
                raise FSFileExistsError(dst_path)
            self.delete(dst_path)
        os.rename(src_path, dst_path)

    def upload(self, local_path, fs_path):
        retry_call(shutil.copy, local_path, fs_path)

    def download(self, fs_path, local_path):
        retry_call(shutil.copy, fs_path, local_path)

    def cat(self, fs_path=None):
        def _read():
            with open(fs_path, "rb") as fh:
                return fh.read()
        return retry_call(_read)

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]


class HDFSClient:
    """Unsupported in this build: construction always raises. The
    filesystem methods are not implemented here, so succeeding past
    __init__ on a hadoop-equipped host would only defer the failure to
    the first method call; it raises up front with the explanation."""

    def __init__(self, hadoop_home=None, configs=None, time_out=5 * 60,
                 sleep_inter=1000):
        raise RuntimeError(
            "HDFSClient is not supported in the PyTorch/CUDA build: the "
            "PS-era HDFS data path is out of its scope (PARITY.md). Use "
            "LocalFS or a mounted filesystem instead.")
