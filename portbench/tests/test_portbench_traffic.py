"""The album: the same from the same seed, other content from another,
and the lengths the traffic file fixes whatever the seed."""

import numpy as np

from portbench import audio, spec


def test_same_seed_same_album():
    a = audio.album([0.5, 0.7], 44100, 2, 16, 2 ** 31 + 17, "cpu")
    b = audio.album([0.5, 0.7], 44100, 2, 16, 2 ** 31 + 17, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_other_seed_other_content_same_lengths():
    a = audio.album([0.5, 0.7], 44100, 2, 24, 3, "cpu")
    b = audio.album([0.5, 0.7], 44100, 2, 24, 4, "cpu")
    assert [x.shape for x in a] == [y.shape for y in b] == [(22050, 2), (30870, 2)]
    assert not any(np.array_equal(x, y) for x, y in zip(a, b))


def test_album_on_the_pcm_grid():
    for bits in (16, 24):
        (x,) = audio.album([0.3], 44100, 2, bits, 9, "cpu")
        scaled = x * 2.0 ** (bits - 1)
        assert np.array_equal(scaled, np.round(scaled))
        assert x.max() < 1.0 and x.min() >= -1.0 and x.std() > 0.01


def test_traffic_lengths_fixed():
    for name in ("track_batch", "track_stream"):
        assert spec.traffic(name)["tracks_s"] == [180, 240, 300]
