"""Scripting helpers for node installs and daemon management (the
port's copy of jepsen_tpu/control/util.py).

Capability reference: jepsen/src/jepsen/control/util.clj — await-tcp-port
(14-30), file?/exists?/ls (32-63), tmp-file!/tmp-dir!/write-file!
(65-106), wget family + cache (108-196), install-archive! (198-264),
ensure-user! (266-273), grepkill! (275-301), start-daemon!/stop-daemon!/
daemon-running?/signal! (303-408).
"""

from __future__ import annotations

import base64
import logging
import os.path
import random
import re

from .. import util as jutil
from . import cd, current_node, exec_, exec_result
from .core import Lit, RemoteError, env_string, escape

logger = logging.getLogger(__name__)

TMP_DIR_BASE = "/tmp/jepsen"
WGET_CACHE_DIR = TMP_DIR_BASE + "/wget-cache"

STD_WGET_OPTS = ["--tries", "20", "--waitretry", "60",
                 "--retry-connrefused", "--dns-timeout", "60",
                 "--connect-timeout", "60", "--read-timeout", "60"]


def await_tcp_port(port, retry_interval: float = 1.0,
                   log_interval: float = 10.0,
                   timeout_secs: float = 60.0) -> None:
    """Blocks until a local TCP port is bound (control/util.clj:14-30)."""
    jutil.await_fn(lambda: exec_("nc", "-z", "localhost", port),
                   retry_interval=retry_interval,
                   log_interval=log_interval, timeout_secs=timeout_secs,
                   log_message=f"Waiting for port {port} ...")


def file_p(filename) -> bool:
    """Is filename a regular file? (control/util.clj file?)"""
    try:
        exec_("test", "-f", filename)
        return True
    except RemoteError:
        return False


def exists_p(path) -> bool:
    """Is a path present? (control/util.clj exists?)"""
    try:
        exec_("stat", path)
        return True
    except RemoteError:
        return False


def ls(directory: str = ".") -> list:
    """Directory entries, without . and .. (control/util.clj:50-56)."""
    out = exec_("ls", "-A", directory)
    return [line for line in out.split("\n") if line.strip()]


def ls_full(directory: str) -> list:
    if not directory.endswith("/"):
        directory += "/"
    return [directory + e for e in ls(directory)]


def tmp_file() -> str:
    """Creates a random temp file under TMP_DIR_BASE, returning its path
    (control/util.clj tmp-file!). Atomic: noclobber create instead of a
    probe-then-touch race (which also loops forever against remotes
    whose stat always succeeds, like the dummy)."""
    exec_("mkdir", "-p", TMP_DIR_BASE)
    while True:
        path = f"{TMP_DIR_BASE}/{random.randrange(2 ** 31)}"
        try:
            exec_("bash", "-c", f"set -C; : > {path}")
            return path
        except RemoteError:
            continue


def tmp_dir() -> str:
    """Creates a random temp dir under TMP_DIR_BASE
    (control/util.clj tmp-dir!). Atomic: bare mkdir fails if present."""
    exec_("mkdir", "-p", TMP_DIR_BASE)
    while True:
        path = f"{TMP_DIR_BASE}/{random.randrange(2 ** 31)}"
        try:
            exec_("mkdir", path)
            return path
        except RemoteError:
            continue


def write_file(string: str, filename) -> str:
    """Writes a string to a remote file via stdin
    (control/util.clj write-file!)."""
    exec_("cat", Lit(">"), filename, stdin=string)
    return filename


def _wget_helper(*args) -> str:
    """wget with retries on network errors (exit 4)
    (control/util.clj wget-helper!)."""
    tries = 5
    while True:
        try:
            return exec_("wget", *args)
        except RemoteError as e:
            if e.exit == 4 and tries > 0:
                tries -= 1
                continue
            raise


def wget(url: str, force: bool = False, user: str | None = None,
         pw: str | None = None) -> str:
    """Downloads url into the cwd unless present; returns the filename
    (control/util.clj wget!)."""
    filename = os.path.basename(url)
    opts = list(STD_WGET_OPTS)
    if user:
        assert pw is not None, "wget auth needs both user and pw"
        opts += ["--user", user, "--password", pw]
    if force:
        exec_("rm", "-f", filename)
    if not exists_p(filename):
        _wget_helper(*opts, url)
    return filename


def cached_wget(url: str, force: bool = False, user: str | None = None,
                pw: str | None = None) -> str:
    """Downloads url into the wget cache keyed by base64(url) — version
    changes in the URL can't silently alias — returning the local path
    (control/util.clj cached-wget!)."""
    encoded = base64.b64encode(url.encode()).decode()
    dest = f"{WGET_CACHE_DIR}/{encoded}"
    opts = list(STD_WGET_OPTS) + ["-O", dest]
    if user:
        assert pw is not None, "wget auth needs both user and pw"
        opts += ["--user", user, "--password", pw]
    if force:
        logger.info("Clearing cached copy of %s", url)
        exec_("rm", "-rf", dest)
    if not exists_p(dest):
        logger.info("Downloading %s", url)
        exec_("mkdir", "-p", WGET_CACHE_DIR)
        with cd(WGET_CACHE_DIR):
            _wget_helper(*opts, url)
    return dest


def expand_path(path: str) -> str:
    if path.startswith("~"):
        return exec_("readlink", "-f", path)
    return path


def install_archive(url: str, dest: str, force: bool = False,
                    user: str | None = None, pw: str | None = None,
                    _retrying: bool = False) -> str:
    """Fetches a tarball/zip (http(s):// via the wget cache, or file://
    on the node), extracts it, and moves its contents to dest
    (control/util.clj install-archive!). A single top-level directory is
    unwrapped: foolib-1.2.3/my.file becomes dest/my.file."""
    m = re.match(r"file://(.+)", url)
    local_file = m.group(1) if m else None
    archive = local_file or cached_wget(url, force=force, user=user, pw=pw)
    tmpdir = tmp_dir()
    dest = expand_path(dest)
    exec_("rm", "-rf", dest)
    parent = exec_("dirname", dest)
    exec_("mkdir", "-p", parent)
    try:
        with cd(tmpdir):
            if re.search(r"\.zip$", url):
                exec_("unzip", archive)
            else:
                exec_("tar", "--no-same-owner", "--no-same-permissions",
                      "--extract", "--file", archive)
            from . import _sudo
            if _sudo.get() == "root":
                exec_("chown", "-R", "root:root", ".")
            roots = ls(tmpdir)
            assert roots, "Archive contained no files"
            if len(roots) == 1:
                exec_("mv", f"{tmpdir}/{roots[0]}", dest)
            else:
                exec_("mv", tmpdir, dest)
    except RemoteError as e:
        err = e.err or ""
        corrupt = ("tar: Unexpected EOF" in err
                   or "This does not look like a tar archive" in err
                   or "cannot find zipfile directory" in err)
        if corrupt:
            if local_file or _retrying:
                raise RuntimeError(
                    f"Local archive {archive} on node {current_node()} "
                    f"is corrupt: {err}") from e
            logger.info("Retrying corrupt archive download")
            exec_("rm", "-rf", archive)
            return install_archive(url, dest, force=True, user=user,
                                   pw=pw, _retrying=True)
        raise
    finally:
        exec_("rm", "-rf", tmpdir)
    return dest


def ensure_user(username: str) -> str:
    """Makes sure a user exists (control/util.clj ensure-user!)."""
    from . import su
    try:
        with su():
            exec_("adduser", "--disabled-password", "--gecos", Lit("''"),
                  username)
    except RemoteError as e:
        if "already exists" not in str(e):
            raise
    return username


def grepkill(pattern, signal="9") -> None:
    """Kills processes matching a pattern. pgrep --ignore-ancestors keeps
    the sudo/bash wrapper running this very command out of the match set
    (control/util.clj grepkill!)."""
    sig = str(signal)
    if not sig.isdigit():
        sig = sig.upper()
    try:
        exec_("pgrep", "-f", "--ignore-ancestors", pattern, Lit("|"),
              "xargs", "--no-run-if-empty", "kill", f"-{sig}")
    except RemoteError as e:
        if e.exit == 0:
            return
        if e.exit == 123 and "No such process" in (e.err or ""):
            return  # process exited between pgrep and kill
        raise


def start_daemon(opts: dict, bin, *args) -> str:
    """Starts a daemon via start-stop-daemon, appending stdout+stderr to
    opts['logfile'] (control/util.clj start-daemon!). Returns 'started'
    or 'already-running'.

    opts: env, background (default True), chdir, exec, logfile,
    make_pidfile (default True), match_executable (default True),
    match_process_name (default False), pidfile, process_name."""
    env = env_string(opts.get("env"))
    ssd: list = ["--start"]
    if opts.get("background", True):
        ssd += ["--background", "--no-close"]
    if opts.get("pidfile") and opts.get("make_pidfile", True):
        ssd += ["--make-pidfile"]
    if opts.get("match_executable", True):
        ssd += ["--exec", opts.get("exec") or bin]
    if opts.get("match_process_name", False):
        ssd += ["--name",
                opts.get("process_name") or os.path.basename(str(bin))]
    if opts.get("pidfile"):
        ssd += ["--pidfile", opts["pidfile"]]
    ssd += ["--chdir", opts["chdir"], "--startas", bin, "--",
            *args, Lit(">>"), opts["logfile"], Lit("2>&1")]
    logger.info("Starting %s", os.path.basename(str(bin)))
    exec_("echo", Lit("`date +'%Y-%m-%d %H:%M:%S'`"),
          f"Jepsen starting {env}{bin} {' '.join(str(a) for a in args)}",
          Lit(">>"), opts["logfile"])
    try:
        exec_(Lit(env.strip()) if env else None, "start-stop-daemon", *ssd)
        return "started"
    except RemoteError as e:
        if e.exit == 1:
            return "already-running"
        raise


def stop_daemon(cmd_or_pidfile, pidfile=None) -> None:
    """Kills a daemon by pidfile, or by command name + pidfile cleanup
    (control/util.clj stop-daemon!)."""
    if pidfile is None and not isinstance(cmd_or_pidfile, tuple):
        pf = cmd_or_pidfile
        if exists_p(pf):
            logger.info("Stopping %s", pf)
            pid = int(exec_("cat", pf))
            jutil.meh(lambda: exec_("kill", "-9", pid))
            jutil.meh(lambda: exec_("rm", "-rf", pf))
        return
    cmd = cmd_or_pidfile
    logger.info("Stopping %s", cmd)
    jutil.meh(lambda: exec_("killall", "-9", "-w", cmd, timeout=30.0))
    if pidfile:
        jutil.meh(lambda: exec_("rm", "-rf", pidfile))


def daemon_running(pidfile) -> bool | None:
    """True if pidfile exists and its process is alive; None if absent;
    False if present but dead (control/util.clj daemon-running?)."""
    try:
        pid = exec_("cat", pidfile)
    except RemoteError:
        return None
    try:
        exec_("ps", "-o", "pid=", "-p", pid)
        return True
    except RemoteError:
        return False


def signal(process_name, sig) -> str:
    """Sends a signal to a named process (control/util.clj signal!)."""
    jutil.meh(lambda: exec_("pkill", "--signal", sig, process_name))
    return "signaled"
