"""Print the task registry (the counterpart of scripts/list_envs.py).

  python -m cat_tpu_torch.list_envs
"""

from cat_tpu_torch.tasks import registry


def main():
    tasks = registry.list_tasks()
    width = max(len(n) for n in tasks) + 2
    print(f"{'Task':<{width}}Description")
    print("-" * (width + 50))
    for name, spec in sorted(tasks.items()):
        print(f"{name:<{width}}{spec.description}")


if __name__ == "__main__":
    main()
