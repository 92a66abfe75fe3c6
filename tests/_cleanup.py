"""An autouse fixture for the port's test files whose tests write
checkpoints into their ``tmp_path`` (hundreds of MB each at resnet18):
each test's ``tmp_path`` is removed when the test is done, so that a run
leaves pytest's temporary directory nearly empty.  A test file imports it
(``from _cleanup import delete_tmp_path``) and pytest finds it there."""
import shutil

import pytest


@pytest.fixture(autouse=True)
def delete_tmp_path(request):
    path = request.getfixturevalue("tmp_path") if "tmp_path" in request.fixturenames else None
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)
