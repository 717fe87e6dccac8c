"""AsyncSearch facade + interactive REPL tests.

The facade mirrors ``SearchThread<T>`` (``src/gui/search_thread.hpp:18-21,
46-98``): UPDATE progress events with the step's display message, COMPLETED
with results, ABORTED when the flag is raised, FAILED carrying the
exception message.
"""

import io
import threading
import time

import numpy as np
import pytest

from monkey_moore_tpu import AsyncSearch, SearchEvent
from monkey_moore_tpu.config import SearchConfig
from monkey_moore_tpu.repl import Repl


@pytest.fixture
def rom(tmp_path, rng):
    data = rng.integers(0, 256, 100_000).astype(np.uint8)
    enc = np.array([ord(c) + 4 for c in "monkey"], dtype=np.uint8)
    for pos in (10, 50_000, 99_994):
        data[pos : pos + 6] = enc
    path = tmp_path / "rom.bin"
    path.write_bytes(data.tobytes())
    return path


class TestAsyncSearch:
    def test_completed_with_results_and_updates(self, rom):
        updates = []
        completed = []
        search = AsyncSearch(
            SearchConfig(file_path=rom, keyword="monkey"),
            on_update=lambda msg, pct: updates.append((msg, pct)),
            on_completed=completed.append,
        ).start()
        assert search.join(timeout=60)
        assert search.outcome is SearchEvent.COMPLETED
        assert [r.offset for r in search.results] == [10, 50_000, 99_994]
        assert completed and completed[0] is search.results
        # previews generated by default (``search_thread.hpp:77``)
        assert all(r.preview for r in search.results)
        # UPDATE parity: step messages + final 100%
        msgs = {m for m, _ in updates}
        assert "Initializing..." in msgs and "Searching..." in msgs
        assert any(p == 100 for _, p in updates)

    def test_aborted_delivers_no_results(self, rom):
        aborted = threading.Event()
        gate = threading.Event()

        def on_update(msg, pct):
            gate.set()
            time.sleep(0.005)

        search = AsyncSearch(
            SearchConfig(file_path=rom, keyword="monkey",
                         preferred_search_block_size=4096,
                         device_chunk_bytes=4096),
            on_update=on_update,
            on_aborted=aborted.set,
        ).start()
        gate.wait(30)
        search.abort()
        assert search.join(timeout=60)
        assert search.outcome is SearchEvent.ABORTED
        assert search.results == []
        assert aborted.is_set()

    def test_failed_carries_message(self, tmp_path):
        failed = []
        search = AsyncSearch(
            SearchConfig(file_path=tmp_path / "missing.bin",
                         keyword="monkey"),
            on_failed=failed.append,
        ).start()
        assert search.join(timeout=30)
        assert search.outcome is SearchEvent.FAILED
        assert failed == [search.error]
        assert "not found" in search.error.lower()

    def test_single_start(self, rom):
        search = AsyncSearch(
            SearchConfig(file_path=rom, keyword="monkey")
        ).start()
        with pytest.raises(RuntimeError):
            search.start()
        search.join(timeout=60)


class TestRepl:
    def _repl(self):
        out = io.StringIO()
        return Repl(out=out), out

    def test_open_search_export_flow(self, rom, tmp_path):
        repl, out = self._repl()
        assert repl.execute(f"open {rom}")
        assert repl.execute("search monkey")
        text = out.getvalue()
        assert "0xA\t" in text  # offset 10 in hex
        assert "3 result(s)" in text
        assert len(repl.last_results) == 3

        tbl = tmp_path / "out.tbl"
        assert repl.execute(f"export 0 {tbl}")
        assert tbl.exists() and tbl.read_text().strip()

    def test_multi_keyword_single_session(self, rom):
        repl, out = self._repl()
        repl.execute(f"open {rom}")
        repl.execute("search monkey nomatchxyz")
        text = out.getvalue()
        assert "# monkey" in text and "# nomatchxyz" in text
        assert "3 result(s)" in text and "0 result(s)" in text

    def test_set_and_show(self, rom):
        repl, out = self._repl()
        repl.execute("set width 16")
        repl.execute("set endian big")
        repl.execute("set semantics all")
        repl.execute("set offsets dec")
        assert repl.width == 2
        assert "width=16" in out.getvalue()
        assert "semantics=all" in out.getvalue()

    def test_value_scan(self, rom, tmp_path):
        data = np.zeros(1000, dtype=np.uint8)
        data[100:104] = [60, 61, 62, 63]
        path = tmp_path / "vals.bin"
        path.write_bytes(data.tobytes())
        repl, out = self._repl()
        repl.execute(f"open {path}")
        repl.execute("value 60 61 62 63")
        assert "0x64\t" in out.getvalue()  # offset 100

    def test_errors_are_messages_not_exceptions(self, tmp_path):
        repl, out = self._repl()
        assert repl.execute("search monkey")  # no file open
        assert "no file open" in out.getvalue()
        assert repl.execute("open /nonexistent/x.bin")
        assert "not found" in out.getvalue()
        assert repl.execute("bogus-command")
        assert "unknown command" in out.getvalue()
        assert repl.execute("export 0 x.tbl")
        assert "out of range" in out.getvalue()

    def test_quit(self):
        repl, _ = self._repl()
        assert repl.execute("quit") is False
        assert repl.execute("exit") is False

    def test_table_edit_before_save(self, rom, tmp_path):
        """The reference's table creator lets the user edit the byte⇔char
        grid before export (``table_creator.cpp:87-195``); the REPL's
        ``table`` workflow is its headless twin."""
        repl, out = self._repl()
        repl.execute(f"open {rom}")
        repl.execute("search monkey")
        assert repl.execute("table 0")
        assert repl.pending_table  # grid loaded and shown
        n0 = len(repl.pending_table)

        repl.execute("table set 20 _")  # add an entry
        assert repl.pending_table["20"] == "_"
        repl.execute("table set 20 -")  # override it
        assert repl.pending_table["20"] == "-"
        repl.execute("table del 20")
        assert "20" not in repl.pending_table
        assert len(repl.pending_table) == n0

        # keys are canonicalized to zero-padded uppercase hex
        repl.execute("table set f !")
        assert repl.pending_table["0F"] == "!"

        tbl = tmp_path / "edited.tbl"
        repl.execute(f"table save {tbl}")
        assert "0F=!" in tbl.read_text()

        # the one-shot export path is unaffected by pending edits
        direct = tmp_path / "direct.tbl"
        repl.execute(f"export 0 {direct}")
        assert "0F=!" not in direct.read_text()

    def test_stats_after_search(self, rom):
        repl, out = self._repl()
        repl.execute(f"open {rom}")
        repl.execute("stats")
        assert "no per-stage stats" in out.getvalue()
        repl.execute("search monkey")
        repl.execute("stats")
        text = out.getvalue()
        # the small test ROM rides the host latency path
        assert "GB/s" in text and "host_scan" in text

    def test_about(self):
        repl, out = self._repl()
        repl.execute("about")
        text = out.getvalue()
        assert "monkey-moore-tpu" in text and "backend:" in text

    def test_table_errors(self, rom, tmp_path):
        repl, out = self._repl()
        assert repl.execute("table show")
        assert "no table loaded" in out.getvalue()
        repl.execute(f"open {rom}")
        repl.execute("search monkey")
        repl.execute("table 99")
        assert "out of range" in out.getvalue()
        repl.execute("table 0")
        repl.execute("table set zz x")
        assert "invalid hex" in out.getvalue()
        repl.execute("table set 100 x")  # exceeds 8-bit element width
        assert "exceeds the element width" in out.getvalue()
        repl.execute("table set -5 x")  # negative hex must be rejected
        assert out.getvalue().count("exceeds the element width") == 2
        assert "-5" not in repl.pending_table
        repl.execute("table del EE")  # not in the grid
        assert "no entry EE" in out.getvalue()

    def test_repeat_search_reuses_resident_corpus(self, rom):
        # the second search must not re-upload (same ResidentCorpus object)
        from monkey_moore_tpu import corpus

        repl, out = self._repl()
        repl.execute(f"open {rom}")
        repl.execute("search monkey banana")
        first = dict(corpus._cache)
        repl.execute("search monkey banana")
        assert dict(corpus._cache) == first  # same cached instance
